"""Train and eval steps (port of `vae_gp_ode_tpu/training/trainer.py`).

One train step is: forward (encoder with train-mode BatchNorm -> z0 ->
L pathwise GP draws as one batch -> the flow: at the default euler the
fused trajectory kernel, with the other solvers the per-step kernels ->
decoder over L*N*T frames), the ELBO, `backward()` (the trajectory's
adjoint kernel once, or the per-step VJP kernel per evaluation), and
Adam over the VAE parameters and the GP leaves jointly. PyTorch updates in place: a step mutates the
`TrainState` and returns its metrics as device tensors.

With a frozen (pretrained) VAE, `freeze_vae`, Adam holds the GP leaves
alone, the VAE parameters take no gradient (the backward pass runs through
the decoder's activations only, and not at all through the encoder), and
the encoder and decoder normalise with their pretrained running
statistics, which never change; in an order-2 run the velocity encoder
keeps train-mode BatchNorm (the reference eval()s only the encoder and
the decoder), so its statistics still move.

Adam is optax.adam's arithmetic, op for op in f32 (`Adam` below), not
torch.optim.Adam: the two differ in how they round the bias corrections,
and that decides whether the first step, which moves every leaf by about
lr, leaves the q(u) scale's 1e-3 diagonal at ~6.6e-9 (optax) or at 0
(torch), where the inducing KL is infinite.

With the default euler and with the other fixed-step solvers the step
never waits for the card: nothing in it reads a device value on the host
(the adaptive solvers read their `done` flags every 16 candidate
steps). Its NaN guard (the JAX package's `_make_epoch_fn` semantics: a
step whose loss is not finite leaves parameters, BatchNorm statistics,
Adam's moments and count, and the step count as they were) is computed on
the device with `torch.where`.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from vae_gp_ode_tpu_torch.gp.svgp import SVGPParams
from vae_gp_ode_tpu_torch.kernels.rbf import rbf_variance
from vae_gp_ode_tpu_torch.models.odegpvae import ODEGPVAE
from vae_gp_ode_tpu_torch.training.objectives import (
    compute_loss, compute_test_error,
)


class Adam:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) over a fixed
    list of f32 tensors, with optax's order of f32 operations:

        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   count += 1
        u  = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
        p  = p + u * (-lr)

    b^count is computed in f64 and rounded to f32 (what XLA's f32 power
    gives, bar an ulp in a few counts). mu and nu live in two flat device
    buffers, `count` is 0-d int32 (optax's one count for all leaves), so
    an update is a handful of launches however many leaves there are.
    """

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.sizes = [p.numel() for p in self.params]
        dev = self.params[0].device
        self.mu = torch.zeros(sum(self.sizes), device=dev)
        self.nu = torch.zeros(sum(self.sizes), device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    def moments(self):
        """(mu, nu): per-leaf views of the flat buffers, leaf-shaped."""
        return tuple([v.view_as(p) for v, p in zip(buf.split(self.sizes),
                                                   self.params)]
                     for buf in (self.mu, self.nu))

    def _bias_correction(self, b, count):
        pw = torch.pow(float(np.float32(b)), count.to(torch.float64))
        return 1.0 - pw.to(torch.float32)

    @torch.no_grad()
    def step(self, g, ok):
        """One update from the flat f32 gradient `g`, applied where the 0-d
        bool tensor `ok` is True; elsewhere parameters, moments and count
        stay as they were."""
        mu = g * (1.0 - self.b1) + self.mu * self.b1
        nu = (g * g) * (1.0 - self.b2) + self.nu * self.b2
        count = self.count + 1
        u = (mu / self._bias_correction(self.b1, count)) / (
            torch.sqrt(nu / self._bias_correction(self.b2, count))
            + self.eps)
        flat = torch.cat([p.reshape(-1) for p in self.params])
        new = flat + u * (-self.lr)
        new = torch.where(ok, new, flat)
        torch._foreach_copy_(self.params, [
            v.view_as(p) for v, p in zip(new.split(self.sizes),
                                         self.params)])
        torch.where(ok, mu, self.mu, out=self.mu)
        torch.where(ok, nu, self.nu, out=self.nu)
        torch.where(ok, count, self.count, out=self.count)


@dataclasses.dataclass
class TrainState:
    """The model (VAE parameters and BatchNorm statistics), the GP leaves,
    Adam over the optimised leaves (`params()` order), the number of
    applied steps (0-d int64 on the model's device), whether the kernel
    hyperparameters are frozen and whether the VAE is (then Adam holds the
    GP leaves alone)."""

    model: ODEGPVAE
    gp: SVGPParams
    optimizer: Adam
    step: torch.Tensor
    fix_kernel: bool = False
    freeze_vae: bool = False

    def params(self):
        """The optimised tensors: VAE parameters (unless the VAE is
        frozen), then the GP leaves in `SVGPParams.parameters()` order."""
        vae = [] if self.freeze_vae else list(self.model.parameters())
        return vae + self.gp.parameters()

    def param_names(self):
        vae = [] if self.freeze_vae else [
            n for n, _ in self.model.named_parameters()]
        return vae + [f'gp.{n}' for n in self.gp.LEAVES]


def create_train_state(model, gp, lr=1e-3, fix_kernel=False,
                       freeze_vae=False):
    """TrainState with `Adam` over the VAE parameters and the GP leaves
    jointly (the JAX package's one Adam over (vae_params, gp)).

    `fix_kernel` freezes the kernel lengthscales and variance: their
    gradients are zeroed before Adam, so their moments stay exactly 0 and
    they do not move, as the JAX package's masked `set_to_zero` does.
    `freeze_vae` freezes the VAE (the pretrained path): Adam keeps no
    moments for it, as the JAX package's `multi_transform` with
    `set_to_zero` does, and its parameters stop requiring gradients.
    """
    gp.requires_grad_(True)
    model.requires_grad_(not freeze_vae)
    state = TrainState(model=model, gp=gp, optimizer=None,
                       step=torch.zeros((), dtype=torch.int64,
                                        device=model.device),
                       fix_kernel=fix_kernel, freeze_vae=freeze_vae)
    state.optimizer = Adam(state.params(), lr=lr)
    return state


def set_train_mode(state: TrainState):
    """BatchNorm modes of a train step: train mode throughout, or, with a
    frozen VAE, eval mode (the pretrained running statistics) for the
    encoder and the decoder and train mode for the velocity encoder of an
    order-2 model (a reference quirk: its statistics still move).
    Returns the model."""
    model = state.model.train(not state.freeze_vae)
    if state.freeze_vae and model.order == 2:
        model.encoder_v.train()
    return model


def bias_before_batchnorm(model):
    """Names of the convolution biases that feed a BatchNorm directly.
    Train-mode BatchNorm subtracts the batch mean, so their gradient is 0
    up to rounding (a reference quirk: the layers keep their biases)."""
    names = []
    for prefix, mod in model.named_modules():
        if isinstance(mod, nn.Sequential):
            kids = list(mod.named_children())
            for (i, a), (_, b) in zip(kids, kids[1:]):
                if isinstance(b, nn.BatchNorm2d) and getattr(
                        a, 'bias', None) is not None:
                    names.append(f'{prefix}.{i}.bias')
    return names


def _bn_stats(model):
    """The running statistics of the BatchNorm layers in train mode (the
    ones a forward pass moves)."""
    return [b for mod in model.modules()
            if isinstance(mod, nn.BatchNorm2d) and mod.training
            for b in (mod.running_mean, mod.running_var)]


def loss_fn(state: TrainState, batch, L: int, num_observations: float,
            eps_guard: bool = False, generator=None,
            noise: Optional[dict] = None):
    """The ELBO of one batch with the model's current BatchNorm mode.

    Returns (loss, (nll, kl_reg, kl_u, nfe)); `noise` injects the model's
    raw draws (see ODEGPVAE), else `generator` draws them.
    """
    Xrec, s_stats, v_stats, nfe = state.model(
        batch, state.gp, L=L, generator=generator, noise=noise)
    loss, nll, kl_reg, kl_u = compute_loss(
        batch, Xrec, s_stats, v_stats, state.gp, num_observations,
        eps_guard=eps_guard)
    return loss, (nll, kl_reg, kl_u, nfe)


def apply_gradients(state: TrainState, ok=None):
    """One Adam update from the gradients in the leaves' `.grad`, skipped
    on the device where the 0-d bool tensor `ok` is False. Increments
    `state.step` where `ok`."""
    if ok is None:
        ok = torch.ones((), dtype=torch.bool, device=state.step.device)
    params = state.params()
    g = torch.cat([p.grad.reshape(-1) for p in params])
    if state.fix_kernel:
        # lengthscales and variance: the first two GP leaves, adjacent
        n_vae = 0 if state.freeze_vae else sum(
            p.numel() for p in state.model.parameters())
        n_kern = sum(p.numel() for p in state.gp.parameters()[:2])
        g[n_vae:n_vae + n_kern] = 0.0
    state.optimizer.step(g, ok)
    state.step.add_(ok.to(state.step.dtype))


def make_train_step(num_observations: float, eps_guard: bool = False):
    """Returns train_step(state, batch, L, generator=None, noise=None) ->
    metrics: loss, backward, Adam, with the NaN guard (which also restores
    the BatchNorm statistics a train-mode module moved). metrics holds 0-d
    device tensors: loss, nll, kl_reg, kl_u, nfe, and kernel_var (the
    kernel variances after the update). A state with a frozen VAE takes
    the frozen step (`set_train_mode`; the JAX package's
    `make_train_step(freeze_vae=True)`)."""

    def train_step(state: TrainState, batch, L: int, generator=None,
                   noise: Optional[dict] = None):
        model = set_train_mode(state)
        bn = _bn_stats(model)
        saved = [b.clone() for b in bn]
        for p in state.params():
            p.grad = None
        loss, (nll, kl_reg, kl_u, nfe) = loss_fn(
            state, batch, L, num_observations, eps_guard, generator, noise)
        loss.backward()
        ok = torch.isfinite(loss)
        apply_gradients(state, ok)
        with torch.no_grad():
            for b, old in zip(bn, saved):
                torch.where(ok, b, old, out=b)
            return {'loss': loss.detach(), 'nll': nll.detach(),
                    'kl_reg': kl_reg.detach(), 'kl_u': kl_u.detach(),
                    'nfe': (nfe.detach() if torch.is_tensor(nfe) else
                            torch.full((), nfe, device=loss.device)),
                    'kernel_var': rbf_variance(state.gp.kernel)}

    return train_step


def run_epoch_with_tail(train_step, state: TrainState, batches, tail,
                        L: int, generator=None):
    """One epoch: a step per batch of `batches` (I, B, ...), then one for
    the ragged tail batch (N % B sequences, or None), as the JAX package's
    `run_epoch_with_tail` does. Returns the metrics stacked per step,
    (I [+ 1],) device tensors."""
    rows = [train_step(state, b, L, generator) for b in batches]
    if tail is not None:
        rows.append(train_step(state, tail, L, generator))
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def make_train_segment(num_observations: float, eps_guard: bool = False):
    """Returns segment(state, X, heads, tails, Xte, test_idx, L,
    generator=None, on_step=None, on_eval=None) -> (metrics, mses): E
    whole training
    epochs, each the train steps over X[heads[e]] (I, B, ...), the ragged
    tail X[tails[e]] (when `tails` is not None) through
    `run_epoch_with_tail`, then the per-epoch monitoring eval on
    Xte[test_idx[e]] at L=1 (train-mode BatchNorm, `make_epoch_eval_step`;
    eval mode with a frozen VAE, `make_eval_step`). heads, tails and
    test_idx are the index tensors of `data.mnist.Loader`'s
    `epoch_index_batches` and `first_index`, drawn from the permutation
    streams that E per-epoch calls would draw from, and the steps and
    evals take `generator`'s draws in the per-epoch order, so a segment
    gives the bits of E per-epoch iterations (the JAX package's
    `make_train_segment`, which only comes within rounding, being a
    separate compilation). `on_step(e)` is called after each train step
    of epoch e of the segment, `on_eval(e, Xrec)` after its monitoring
    eval with the reconstructions (1, B, T, ...).

    metrics: per-step device tensors stacked (E, I [+ 1]); mses (E,). No
    value is read on the host; the frozen-VAE check stays with the
    caller, once per segment on its final weights (weights change only
    through updates).
    """
    return segment_of(make_train_step(num_observations, eps_guard))


def segment_of(train_step):
    """`make_train_segment`'s segment over the steps of `train_step`
    (train_step(state, batch, L, generator) -> metrics; the data-parallel
    step of `parallel.shard_dp` too: the monitoring eval then runs on
    every rank, on the whole test batch)."""

    def segment(state: TrainState, X, heads, tails, Xte, test_idx, L: int,
                generator=None, on_step=None, on_eval=None):
        epoch_eval = (make_eval_step() if state.freeze_vae
                      else make_epoch_eval_step())
        rows, mses = [], []
        for e in range(heads.shape[0]):
            def step(st, batch, L_, gen, e=e):
                metrics = train_step(st, batch, L_, gen)
                if on_step is not None:
                    on_step(e)
                return metrics
            rows.append(run_epoch_with_tail(
                step, state, X[heads[e]],
                None if tails is None else X[tails[e]], L, generator))
            Xrec, mse = epoch_eval(state, Xte[test_idx[e]], 1, generator)
            if on_eval is not None:
                on_eval(e, Xrec)
            mses.append(mse)
        return ({k: torch.stack([r[k] for r in rows]) for k in rows[0]},
                torch.stack(mses))

    return segment


def make_eval_step(T_custom: Optional[int] = None):
    """Returns eval_step(state, batch, L=1, generator=None, noise=None) ->
    (Xrec, mse) with eval-mode BatchNorm (running statistics): the
    published-number protocol. mse is 0 for a T_custom rollout."""

    def eval_step(state: TrainState, batch, L: int = 1, generator=None,
                  noise: Optional[dict] = None):
        model = state.model.eval()
        with torch.no_grad():
            Xrec, _, _, _ = model(batch, state.gp, L=L, T_custom=T_custom,
                                  generator=generator, noise=noise)
            if T_custom is None:
                mse = compute_test_error(batch, torch.mean(Xrec, dim=0))
            else:
                mse = torch.zeros((), device=Xrec.device)
        return Xrec, mse

    return eval_step


def make_epoch_eval_step():
    """Returns eval_step(state, batch, L=1, generator=None, noise=None) ->
    (Xrec, mse): the per-epoch monitoring eval, which never leaves train
    mode, so BatchNorm normalises with the test batch's statistics and
    updates its running statistics (under no_grad), as the JAX package's
    `make_epoch_eval_step` does. A run with a frozen VAE monitors with
    `make_eval_step` instead (the reference eval()s its VAE there)."""

    def eval_step(state: TrainState, batch, L: int = 1, generator=None,
                  noise: Optional[dict] = None):
        model = state.model.train()
        with torch.no_grad():
            Xrec, _, _, _ = model(batch, state.gp, L=L, generator=generator,
                                  noise=noise)
            mse = compute_test_error(batch, torch.mean(Xrec, dim=0))
        return Xrec, mse

    return eval_step
