"""The plain reference agrees with the port on the CPU at small widths,
for both configurations: a forecast (the forward pass), one train step
(the ELBO's terms, the first gradient as Adam holds it, the leaves after
Adam) and the checkpoint's arrays as each side reads them."""

import os
import statistics

import pytest
import torch

from portbench.tests import small  # noqa: F401
from portbench.harness import compare, data, program, spec, weights
from portbench.reference import model as ref

BENCH = spec.benchmark()
CPU = torch.device('cpu')


def _cfg(name, **kw):
    return dict(spec.config(BENCH, name), **kw)


SMALL = {'rbf-q6': _cfg('rbf-q6', num_features=32, num_inducing=16),
         'df-q6': _cfg('df-q6', weights='seed', num_features=16,
                       num_inducing=8)}


def _state(cfg, seed=7):
    return weights.random_state(cfg, data.generator(seed, 2, CPU), CPU)


@pytest.mark.parametrize('name', sorted(SMALL))
def test_forecast_matches_the_port(name):
    cfg = SMALL[name]
    st = _state(cfg)
    X = data.rotating_sequences(3, cfg['T'], data.generator(1, 1, CPU), CPU)
    fn = program.forecaster(cfg, spec.ROOT, st, 2, CPU)
    got = fn(X, 99)
    noise = ref.draw_noise(cfg, 3, 2, torch.Generator().manual_seed(99), CPU)
    want = ref.forecast(cfg, st['params'], X, noise, 2, ref.Ops('f32'))
    assert got.shape == want.shape == (2, 3, cfg['T'], 1, 28, 28)
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize('name', sorted(SMALL))
def test_train_step_matches_the_port(name):
    from vae_gp_ode_tpu_torch.training.trainer import make_train_step
    cfg = SMALL[name]
    st0 = _state(cfg)
    X = data.rotating_sequences(4, cfg['T'], data.generator(2, 1, CPU), CPU)
    pst = program.train_state(cfg, spec.ROOT, st0, CPU)
    gen = torch.Generator().manual_seed(5)
    m = make_train_step(cfg['Ndata'], eps_guard=cfg['eps_guard'])(
        pst, X, 2, gen)
    params, mu = program.leaves(pst)
    noise = ref.draw_noise(cfg, 4, 2, torch.Generator().manual_seed(5), CPU)
    steps, P1 = ref.train_steps(cfg, st0['params'], st0['adam'], [X],
                                [noise], 2, float(cfg['Ndata']), cfg['lr'],
                                ref.Ops('f32'))
    for k in ('loss', 'nll', 'kl_reg', 'kl_u'):
        assert abs(float(m[k]) - steps[0][k]) <= 1e-5 * abs(steps[0][k])
    grads = steps[0]['grads']
    norms = {n: float(g.norm()) for n, g in grads.items()}
    floor = compare.GRAD_FLOOR * statistics.median(norms.values())
    for n, g in grads.items():
        if norms[n] < floor:
            # a bias before BatchNorm: its gradient is round-off, and
            # Adam moves it by about lr either way
            continue
        # the difference's norm against the leaf's: rounding and the
        # occasional ReLU that flips between the two sides
        assert float((mu[n] / 0.1 - g).norm()) <= 1e-2 * norms[n], n
        scale = float(g.abs().max())
        # Adam's first step moves each entry by about lr times the sign
        # of its gradient: entries whose gradient is round-off may move
        # either way
        sure = g.abs() > 1e-2 * scale
        assert float((params[n].detach() - P1[n])[sure].abs().max()) <= (
            1e-6 + 1e-4 * float(P1[n].abs().max())), n


def test_checkpoint_read_as_the_port_reads_it():
    cfg = spec.config(BENCH, 'df-q6')
    st = program.train_state(cfg, spec.ROOT, None, CPU)
    mine = weights.checkpoint_state(os.path.join(
        spec.ROOT, cfg['run_dir'], 'odegpvae_mnist.ckpt'), CPU)
    params, mu = program.leaves(st)
    nu = dict(zip(st.param_names(), st.optimizer.moments()[1]))
    for n, t in params.items():
        assert torch.equal(t.detach(), mine['params'][n]), n
        assert torch.equal(mu[n], mine['adam']['mu'][n]), n
        assert torch.equal(nu[n], mine['adam']['nu'][n]), n
    sd = st.model.state_dict()
    for n, t in mine['params'].items():
        if ref.is_stat(n):
            assert torch.equal(sd[n], t), n
    assert int(st.optimizer.count) == mine['adam']['count']
    assert int(st.step) == mine['step']


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -2.5e-3,
                      float('inf')])
    r = ref.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2 ** -9
    assert float((r[3] - x[3]).abs()) <= 2 ** -11 * 2.5e-3
    assert torch.isinf(r[4])
