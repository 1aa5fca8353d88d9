"""Train and eval steps (port of `vae_gp_ode_tpu/training/trainer.py`).

One train step is: forward (encoder with train-mode BatchNorm -> z0 ->
L pathwise GP draws as one batch -> the flow: at the default euler the
fused trajectory kernel, with the other solvers the per-step kernels ->
decoder over L*N*T frames), the ELBO, `backward()` (the trajectory's
adjoint kernel once, or the per-step VJP kernel per evaluation), and
Adam over the VAE parameters and the GP leaves jointly. PyTorch updates in place: a step mutates the
`TrainState` and returns its metrics as device tensors.

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
    Adam over both (`params()` order), the number of applied steps (0-d
    int64 on the model's device), and whether the kernel hyperparameters
    are frozen."""

    model: ODEGPVAE
    gp: SVGPParams
    optimizer: Adam
    step: torch.Tensor
    fix_kernel: bool = False

    def params(self):
        """The optimised tensors: VAE parameters, then the GP leaves in
        `SVGPParams.parameters()` order."""
        return list(self.model.parameters()) + self.gp.parameters()

    def param_names(self):
        return ([n for n, _ in self.model.named_parameters()]
                + [f'gp.{n}' for n in self.gp.LEAVES])


def create_train_state(model, gp, lr=1e-3, fix_kernel=False,
                       freeze_vae=False):
    """TrainState with `Adam` over the VAE parameters and the GP leaves
    jointly (the JAX package's one Adam over (vae_params, gp)).

    `fix_kernel` freezes the kernel lengthscales and variance: their
    gradients are zeroed before Adam, so their moments stay exactly 0 and
    they do not move, as the JAX package's masked `set_to_zero` does.
    """
    if freeze_vae:
        raise NotImplementedError(
            'freeze_vae (the pretrained-VAE path) is not ported yet (ROADMAP '
            'Queue A item 9)')
    gp.requires_grad_(True)
    state = TrainState(model=model, gp=gp, optimizer=None,
                       step=torch.zeros((), dtype=torch.int64,
                                        device=model.device),
                       fix_kernel=fix_kernel)
    state.optimizer = Adam(state.params(), lr=lr)
    return state


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
    return [b for name, b in model.named_buffers()
            if name.endswith(('running_mean', 'running_var'))]


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
        n_vae = sum(p.numel() for p in state.model.parameters())
        n_kern = sum(p.numel() for p in state.gp.parameters()[:2])
        g[n_vae:n_vae + n_kern] = 0.0
    state.optimizer.step(g, ok)
    state.step.add_(ok.to(state.step.dtype))


def make_train_step(num_observations: float, eps_guard: bool = False):
    """Returns train_step(state, batch, L, generator=None, noise=None) ->
    metrics: loss, backward, Adam, with the NaN guard. metrics holds 0-d
    device tensors: loss, nll, kl_reg, kl_u, nfe, and kernel_var (the
    kernel variances after the update)."""

    def train_step(state: TrainState, batch, L: int, generator=None,
                   noise: Optional[dict] = None):
        model = state.model.train()
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
    `make_epoch_eval_step` does."""

    def eval_step(state: TrainState, batch, L: int = 1, generator=None,
                  noise: Optional[dict] = None):
        model = state.model.train()
        with torch.no_grad():
            Xrec, _, _, _ = model(batch, state.gp, L=L, generator=generator,
                                  noise=noise)
            mse = compute_test_error(batch, torch.mean(Xrec, dim=0))
        return Xrec, mse

    return eval_step
