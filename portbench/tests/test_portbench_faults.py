"""`correct` comes out false when the timed path is broken underneath:
the control (the reference with TF32 products) fails a limit, and so
does each fault a cell can have, planted in the port while the rest of
the run goes as usual (on the CPU, at small sizes)."""

import pytest
import torch

from portbench.tests import small
from portbench.harness import compare, spec


@pytest.mark.parametrize('cell', small.CELLS)
def test_control_fails_a_limit(cell):
    res, _ = small.run(cell, judge=False, control=True)
    ok, _ = compare.judge(res['control']['control'], spec.limits(cell))
    assert not ok


def _unchanged_state(monkeypatch):
    from vae_gp_ode_tpu_torch.training import trainer
    monkeypatch.setattr(trainer, 'apply_gradients',
                        lambda state, ok=None: None)


def _half_batch(monkeypatch):
    from vae_gp_ode_tpu_torch.training import trainer
    loss_fn = trainer.loss_fn

    def half(state, batch, *a, **kw):
        return loss_fn(state, batch[:batch.shape[0] // 2], *a, **kw)
    monkeypatch.setattr(trainer, 'loss_fn', half)


def _answer_fault(monkeypatch, alter):
    """Every answer of the port's forecaster altered by `alter(out)`."""
    from vae_gp_ode_tpu_torch import serving
    make = serving.make_forecast_fn

    def altered(*a, **kw):
        fn = make(*a, **kw)

        def wrong(X, seed, noise=None):
            out = fn(X, seed, noise)
            alter(out)
            return out
        return wrong
    monkeypatch.setattr(serving, 'make_forecast_fn', altered)


def _altered_pixel(monkeypatch):
    def alter(out):
        out[0, 0, 0] += 0.5
    _answer_fault(monkeypatch, alter)


def _replaced_draw(monkeypatch):
    def alter(out):
        out[-1] = out[0]
    _answer_fault(monkeypatch, alter)


TRAIN_FAULTS = [_unchanged_state, _half_batch]
FORECAST_FAULTS = [_altered_pixel, _replaced_draw]


@pytest.mark.parametrize('cell', [c for c in small.CELLS if '.train' in c])
@pytest.mark.parametrize('fault', TRAIN_FAULTS)
def test_train_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res, _ = small.run(cell)
    assert res['correct'] is False


@pytest.mark.parametrize('cell', [c for c in small.CELLS if '.forecast' in c])
@pytest.mark.parametrize('fault', FORECAST_FAULTS)
def test_altered_answer_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res, _ = small.run(cell)
    assert res['correct'] is False
    assert torch.isfinite(torch.tensor(res['numbers']['frames_gap']))
