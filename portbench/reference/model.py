"""The model in plain PyTorch: conv VAE, sparse variational GP with
pathwise posterior samples (dimwise RBF or divergence-free kernel, random
Fourier features and the pathwise update), euler integration, the ELBO
and Adam.

Every formula follows the published model as the port states it (the
port's plain versions, frozen here so that the yardstick does not move
with the program). Parameters are a dict of named float32 tensors in the
port's layout (`vae_leaves`, `GP_LEAVES`); noise is a dict of raw draws
drawn by `draw_noise` in the order the model draws them.

`prec='tf32'` rounds both operands of every matrix product and
convolution to TF32 (10 explicit mantissa bits, round to nearest even)
and accumulates in float32, as the tensor cores do with TF32 on, in the
forward pass and in the products of the backward pass (the incoming
gradient rounded, the saved operands already are): the benchmark's
control, one precision below the float32 with TF32 off that the
configurations state.
"""

import math

import torch
import torch.nn.functional as F

JITTER = 1e-5
SOFTPLUS_LOWER = 1e-12
BERNOULLI_EPS = 1e-3
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
GP_LEAVES = ('gp.kernel.unconstrained_lengthscales',
             'gp.kernel.unconstrained_variance', 'gp.inducing_loc', 'gp.Um',
             'gp.Us_sqrt')


def round_tf32(x):
    """x rounded to TF32 (float32 with the low 13 mantissa bits cleared,
    round to nearest even); inf and nan pass through."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    r = torch.where(torch.isfinite(x), r, i)
    return r.view(torch.float32)


class _Round(torch.autograd.Function):
    """TF32 rounding in the forward pass; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """The identity, whose incoming gradient is rounded to TF32."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class Ops:
    """The products of the model in one precision ('f32' or 'tf32')."""

    def __init__(self, prec='f32'):
        if prec not in ('f32', 'tf32'):
            raise ValueError(f'unknown precision {prec!r}')
        self.prec = prec

    def _r(self, x):
        return _Round.apply(x) if self.prec == 'tf32' else x

    def _g(self, y):
        return _RoundGrad.apply(y) if self.prec == 'tf32' else y

    def mm(self, a, b):
        return self._g(torch.matmul(self._r(a), self._r(b)))

    def conv(self, x, w, b, stride, pad):
        return self._g(F.conv2d(self._r(x), self._r(w), None, stride,
                                pad)) + b[:, None, None]

    def conv_t(self, x, w, b, stride, pad, out_pad=0):
        return self._g(F.conv_transpose2d(self._r(x), self._r(w), None,
                                          stride, pad, out_pad)) + \
            b[:, None, None]

    def linear(self, x, w, b):
        return self.mm(x, w.t()) + b


# -- the VAE ----------------------------------------------------------------

def vae_leaves(latent_dim, n_filt):
    """[(name, shape, kind, fan_in)] of the VAE's parameters and BatchNorm
    statistics in the port's layout; kind is 'w' (weight), 'b' (bias),
    'bn_w', 'bn_b', 'bn_mean' or 'bn_var'."""
    nf, q = n_filt, latent_dim
    out = []

    def conv(name, cout, cin, k):
        out.extend([(f'{name}.weight', (cout, cin, k, k), 'w', cin * k * k),
                    (f'{name}.bias', (cout,), 'b', 0)])

    def conv_t(name, cin, cout, k):
        out.extend([(f'{name}.weight', (cin, cout, k, k), 'w', cin * k * k),
                    (f'{name}.bias', (cout,), 'b', 0)])

    def bn(name, c):
        out.extend([(f'{name}.weight', (c,), 'bn_w', 0),
                    (f'{name}.bias', (c,), 'bn_b', 0),
                    (f'{name}.running_mean', (c,), 'bn_mean', 0),
                    (f'{name}.running_var', (c,), 'bn_var', 0)])

    def linear(name, cout, cin):
        out.extend([(f'{name}.weight', (cout, cin), 'w', cin),
                    (f'{name}.bias', (cout,), 'b', 0)])

    conv('encoder.cnn.0', nf, 1, 5)
    bn('encoder.cnn.1', nf)
    conv('encoder.cnn.3', 2 * nf, nf, 5)
    bn('encoder.cnn.4', 2 * nf)
    conv('encoder.cnn.6', 4 * nf, 2 * nf, 5)
    linear('encoder.fc', 2 * q, 4 * nf * 16)
    linear('decoder.fc', 4 * nf * 16, q)
    conv_t('decoder.decnn.1', 4 * nf, 8 * nf, 3)
    bn('decoder.decnn.2', 8 * nf)
    conv_t('decoder.decnn.4', 8 * nf, 4 * nf, 5)
    bn('decoder.decnn.5', 4 * nf)
    conv_t('decoder.decnn.7', 4 * nf, 2 * nf, 5)
    bn('decoder.decnn.8', 2 * nf)
    conv_t('decoder.decnn.10', 2 * nf, 1, 5)
    return out


def is_stat(name):
    return name.endswith(('running_mean', 'running_var'))


def batch_norm(P, name, x, train, stats=None):
    """BatchNorm over (N, H, W) with the batch's biased variance in train
    mode (appending the statistics' new values to `stats`, flax's update:
    0.1 of the way to the batch mean and biased variance), the running
    statistics in eval mode."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
        if stats is not None:
            with torch.no_grad():
                stats[f'{name}.running_mean'] = torch.lerp(
                    P[f'{name}.running_mean'], mean, BN_MOMENTUM)
                stats[f'{name}.running_var'] = torch.lerp(
                    P[f'{name}.running_var'], var, BN_MOMENTUM)
    else:
        mean, var = P[f'{name}.running_mean'], P[f'{name}.running_var']
    y = (x - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
    return y * P[f'{name}.weight'][:, None, None] + \
        P[f'{name}.bias'][:, None, None]


def encode(P, ops, x, train, stats=None):
    """Frames (N, 1, 28, 28) -> (mu, logvar), each (N, q)."""
    def w(n):
        return P[f'encoder.{n}.weight'], P[f'encoder.{n}.bias']
    h = ops.conv(x, *w('cnn.0'), 2, 2)
    h = F.relu(batch_norm(P, 'encoder.cnn.1', h, train, stats))
    h = ops.conv(h, *w('cnn.3'), 2, 2)
    h = F.relu(batch_norm(P, 'encoder.cnn.4', h, train, stats))
    h = F.relu(ops.conv(h, *w('cnn.6'), 2, 2))
    h = ops.linear(h.reshape(h.shape[0], -1), *w('fc'))
    return h.chunk(2, dim=-1)


def decode(P, ops, z, train, stats=None):
    """Latent states (B, q) -> frames (B, 1, 28, 28) in (0, 1)."""
    def w(n):
        return P[f'decoder.{n}.weight'], P[f'decoder.{n}.bias']
    h = ops.linear(z, *w('fc'))
    h = h.reshape(h.shape[0], -1, 4, 4)
    h = ops.conv_t(h, *w('decnn.1'), 1, 0)
    h = F.relu(batch_norm(P, 'decoder.decnn.2', h, train, stats))
    h = ops.conv_t(h, *w('decnn.4'), 2, 1)
    h = F.relu(batch_norm(P, 'decoder.decnn.5', h, train, stats))
    h = ops.conv_t(h, *w('decnn.7'), 2, 1, 1)
    h = F.relu(batch_norm(P, 'decoder.decnn.8', h, train, stats))
    return torch.sigmoid(ops.conv_t(h, *w('decnn.10'), 1, 2))


# -- the GP ------------------------------------------------------------------

def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x)) + SOFTPLUS_LOWER


def unpack_tril(v, n):
    rows, cols = torch.tril_indices(n, n, device=v.device)
    out = v.new_zeros(v.shape[:-1] + (n, n))
    out[..., rows, cols] = v
    return out


def cholesky(A):
    """Lower factor of (A + A^T) / 2; NaN where it is not positive
    definite."""
    L, info = torch.linalg.cholesky_ex((A + A.transpose(-1, -2)) / 2)
    return torch.where((info == 0)[..., None, None], L, float('nan')).tril()


def noise_spec(cfg, N, L):
    """[(name, shape, draw)] of one forward pass's raw draws in the order
    the model draws them: z0, then the L GP draws' omega, phase, weights
    and the inducing epsilon."""
    q, S, M = cfg['latent_dim'], cfg['num_features'], cfg['num_inducing']
    df = cfg['kernel'] == 'DF'
    return [('z0', (N, q), 'normal'),
            ('omega', (L, q, S, q), 'normal'),
            ('phase_u', (L, 1, S, q), 'uniform'),
            ('weights', (L, 2 * S if df else S, q), 'normal'),
            ('epsilon', (L, M, q), 'normal')]


def draw_noise(cfg, N, L, generator, device):
    draws = {'normal': torch.randn, 'uniform': torch.rand}
    return {name: draws[d](shape, generator=generator, dtype=torch.float32,
                           device=device)
            for name, shape, d in noise_spec(cfg, N, L)}


def _rbf_gram(ops, ls, var, X, X2):
    """Dimwise RBF gram (..., D, N, M): per output dim d,
    var_d exp(-|x / ls_d - x2 / ls_d|^2 / 2)."""
    Xd = X[..., None, :, :] / ls[:, None, :]
    X2d = X2[..., None, :, :] / ls[:, None, :]
    sq = (-2.0 * ops.mm(Xd, X2d.transpose(-1, -2))
          + (Xd * Xd).sum(-1)[..., :, None] + (X2d * X2d).sum(-1)[..., None, :])
    return var[:, None, None] * torch.exp(-0.5 * sq)


def _df_gram(ops, ls, var, X, X2):
    """Divergence-free gram (..., N*D, M*D): an RBF envelope with the
    (D, D) lengthscale matrix per output-dim pair times
    (d d^T / l^2 + ((D - 1) - r^2 / l^2) I) / l^2."""
    D = X.shape[-1]
    ls2 = ls * ls
    sq = (-2.0 * ops.mm(X, X2.transpose(-1, -2)) + (X * X).sum(-1)[..., :, None]
          + (X2 * X2).sum(-1)[..., None, :])[..., None, None]
    env = var * torch.exp(-sq / (2.0 * ls2))
    diff = X2[..., None, :, :] - X[..., :, None, :]
    term1 = diff[..., :, None] * diff[..., None, :] / ls2
    eye = torch.eye(D, dtype=X.dtype, device=X.device)
    K = env * (term1 + ((D - 1.0) - sq / ls2) * eye) / ls2
    N, M = K.shape[-4], K.shape[-3]
    return K.transpose(-3, -2).reshape(K.shape[:-4] + (N * D, M * D))


class Sample:
    """L pathwise posterior function draws f(x) = prior(x) + K(x, Z) nu."""

    def __init__(self, cfg, P, noise, ops):
        self.df = cfg['kernel'] == 'DF'
        self.ops = ops
        S = cfg['num_features']
        ls = softplus(P['gp.kernel.unconstrained_lengthscales'])
        var = softplus(P['gp.kernel.unconstrained_variance'])
        self.ls, self.var, self.Z = ls, var, P['gp.inducing_loc']
        Z, Um = self.Z, P['gp.Um']
        M, D = Um.shape
        L = noise['omega'].shape[0]
        self.omega = noise['omega'] / ls.T[:, None, :]         # (L, D, S, D)
        self.phase = noise['phase_u'] * (2.0 * math.pi)        # (L, 1, S, D)
        self.weights = noise['weights']
        self.S = S
        if self.df:
            om1 = self.omega.transpose(-3, -2)                 # (L, S, D, D)
            ww = ops.mm(om1, om1.transpose(-1, -2))
            norm = torch.sqrt((self.omega ** 2).sum(-3))[..., :, None, :]
            eye = torch.eye(D, dtype=Z.dtype, device=Z.device)
            B = norm * eye - ww / norm
            B = torch.cat([B, B], dim=-3)                      # (L, 2S, D, D)
            G = B * self.weights[..., :, :, None] * torch.sqrt(var / S)
            self.G = G.reshape(L, 2 * S * D, D)
        # u ~ q(u), whitened: Lq eps + m
        Lq = unpack_tril(P['gp.Us_sqrt'], M)                   # (D, M, M)
        e = noise['epsilon'].transpose(-1, -2)[..., None]      # (L, D, M, 1)
        u = ops.mm(Lq, e)[..., 0].transpose(-1, -2) + Um       # (L, M, D)
        up = self.prior(Z.expand(L, M, D))                     # (L, M, D)
        if self.df:
            MD = M * D
            Ku = _df_gram(ops, ls, var, Z, Z)
            Lu = cholesky(Ku + torch.eye(MD, dtype=Z.dtype,
                                         device=Z.device) * JITTER)
            a = torch.linalg.solve_triangular(
                Lu, up.reshape(L, MD, 1), upper=False)
            self.nu = torch.linalg.solve_triangular(
                Lu.transpose(-1, -2), u.reshape(L, MD, 1) - a, upper=True)
        else:
            Ku = _rbf_gram(ops, ls, var, Z, Z)                 # (D, M, M)
            Lu = cholesky(Ku + torch.eye(M, dtype=Z.dtype,
                                         device=Z.device) * JITTER)
            a = torch.linalg.solve_triangular(
                Lu, up.transpose(-1, -2)[..., None], upper=False)
            self.nu = torch.linalg.solve_triangular(
                Lu.transpose(-1, -2), u.transpose(-1, -2)[..., None] - a,
                upper=True)                                    # (L, D, M, 1)

    def prior(self, x):
        """The RFF prior draws at x (L, N, D) -> (L, N, D)."""
        L, N, D = x.shape
        S = self.S
        xo = self.ops.mm(x, self.omega.reshape(L, D, S * D)).reshape(
            L, N, S, D) + self.phase
        if self.df:
            trig = torch.cat([torch.cos(xo), torch.sin(xo)], dim=-2)
            return self.ops.mm(trig.reshape(L, N, 2 * S * D), self.G)
        phi = torch.cos(xo) * torch.sqrt(self.var / S)
        return (phi * self.weights[:, None]).sum(-2)

    def update(self, x):
        """The pathwise update K(x, Z) nu at x (L, N, D) -> (L, N, D)."""
        L, N, D = x.shape
        if self.df:
            Kuf = _df_gram(self.ops, self.ls, self.var, self.Z, x)
            return self.ops.mm(Kuf.transpose(-1, -2), self.nu).reshape(
                L, N, D)
        Kuf = _rbf_gram(self.ops, self.ls, self.var, self.Z, x)  # (L,D,M,N)
        f = self.ops.mm(self.nu.transpose(-1, -2), Kuf)          # (L,D,1,N)
        return f[..., 0, :].transpose(-1, -2)

    def __call__(self, x):
        return self.prior(x) + self.update(x)


def euler(f, z0, T, dt):
    """z_{t+1} = z_t + dt_t f(z_t) over the time grid dt * arange(T) in
    float32; z0 (L, N, D) -> (L, N, T, D)."""
    ts = dt * torch.arange(T, dtype=torch.float32, device=z0.device)
    dts = torch.diff(ts)
    zs = [z0]
    for i in range(T - 1):
        zs.append(zs[-1] + dts[i] * f(zs[-1]))
    return torch.stack(zs, dim=2)


def svgp_kl(P):
    """Whitened KL(q(u) || N(0, I)) of the full-Cholesky q(u)."""
    Um = P['gp.Um']
    M = Um.shape[0]
    Lq = unpack_tril(P['gp.Us_sqrt'], M)
    diag = torch.diagonal(Lq, dim1=1, dim2=2).T
    two_kl = (-(torch.log(diag ** 2)).sum(0) + (Um ** 2).sum(0)
              + (Lq ** 2).sum((1, 2)) - float(M))
    return 0.5 * two_kl.sum()


def forward(cfg, P, X, noise, ops, train, L, stats=None):
    """Frames X (N, T, 1, d, d) -> (Xrec (L, N, T, 1, d, d), mu, logvar)."""
    N, T = X.shape[:2]
    q = cfg['latent_dim']
    mu, logvar = encode(P, ops, X[:, 0], train, stats)
    z0 = mu + torch.exp(0.5 * logvar) * noise['z0']
    f = Sample(cfg, P, noise, ops)
    zs = euler(f, z0.expand(L, N, q), T, cfg['dt'])
    Xrec = decode(P, ops, zs.reshape(L * N * T, q), train, stats)
    return Xrec.reshape((L, N, T) + Xrec.shape[1:]), mu, logvar


def elbo(cfg, P, X, Xrec, mu, logvar, n_obs):
    """(loss, nll, kl_reg, kl_u): loss = -(lhood N_obs - kl_reg N_obs -
    kl_u), with the epsilon-guarded Bernoulli log-likelihood summed over
    frames and pixels and averaged over draws and sequences."""
    x = X[None]
    lp = (torch.log(BERNOULLI_EPS + Xrec) * x
          + torch.log(BERNOULLI_EPS + 1.0 - Xrec) * (1.0 - x))
    lhood = lp.sum(dim=(2, 3, 4, 5)).mean(0).mean()
    kl_reg = (0.5 * (torch.exp(logvar) + mu ** 2 - 1.0 - logvar).sum(-1)).mean()
    kl_u = svgp_kl(P)
    loss = -(lhood * n_obs - kl_reg * n_obs - kl_u)
    return loss, -lhood, kl_reg, kl_u


def trainable(P):
    """Names of the optimised leaves, in a fixed order."""
    return [n for n in P if not is_stat(n)]


def _bias_correction(b, count):
    """1 - b^count in float32, b^count taken in float64 from float32 b
    and rounded (optax's float32 arithmetic)."""
    return torch.tensor(1.0, dtype=torch.float32) - torch.tensor(
        float(torch.tensor(b, dtype=torch.float32)) ** count,
        dtype=torch.float64).float()


def adam_step(P, grads, adam, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam update of the leaves in place, with optax's order of
    float32 operations (at the first step a leaf moves by lr times
    1 - eps / |g| up to rounding, so the q(u) scale's 1e-3 diagonal lands
    within a few ulps of 0 and the rounding decides where); adam =
    {'count': int, 'mu': {name: tensor}, 'nu': {name: tensor}} is updated
    in place."""
    adam['count'] += 1
    c = adam['count']
    with torch.no_grad():
        for n, g in grads.items():
            dev = g.device
            bc1 = _bias_correction(b1, c).to(dev)
            bc2 = _bias_correction(b2, c).to(dev)
            mu = g * (1.0 - b1) + adam['mu'][n] * b1
            nu = (g * g) * (1.0 - b2) + adam['nu'][n] * b2
            adam['mu'][n], adam['nu'][n] = mu, nu
            P[n] = P[n] + ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)) * (-lr)


def train_steps(cfg, P, adam, batches, noises, L, n_obs, lr, ops):
    """Train steps on `batches` with `noises`, from leaves P and Adam
    state `adam` (both copied, not changed). Returns per step a dict of
    loss, nll, kl_reg, kl_u (floats) and grads ({name: tensor}), and the
    leaves after the last step."""
    P = {n: t.detach().clone() for n, t in P.items()}
    adam = {'count': adam['count'],
            'mu': {n: t.clone() for n, t in adam['mu'].items()},
            'nu': {n: t.clone() for n, t in adam['nu'].items()}}
    names = trainable(P)
    out = []
    for X, noise in zip(batches, noises):
        leaves = {n: P[n].detach().requires_grad_(True) for n in names}
        Pg = dict(P, **leaves)
        stats = {}
        Xrec, mu, logvar = forward(cfg, Pg, X, noise, ops, True, L, stats)
        loss, nll, kl_reg, kl_u = elbo(cfg, Pg, X, Xrec, mu, logvar, n_obs)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        grads = dict(zip(names, grads))
        out.append({'loss': loss.item(), 'nll': nll.item(),
                    'kl_reg': kl_reg.item(), 'kl_u': kl_u.item(),
                    'grads': grads})
        P.update(stats)
        adam_step(P, grads, adam, lr)
        del Xrec, loss
    return out, P


@torch.no_grad()
def forecast(cfg, P, X, noise, L, ops):
    """Eval-mode forecast frames (L, N, T, 1, d, d) of sequences X."""
    N, T = X.shape[:2]
    q = cfg['latent_dim']
    mu, logvar = encode(P, ops, X[:, 0], False)
    z0 = mu + torch.exp(0.5 * logvar) * noise['z0']
    f = Sample(cfg, P, noise, ops)
    zs = euler(f, z0.expand(L, N, q), T, cfg['dt']).reshape(L * N * T, q)
    frames = decode(P, ops, zs, False)
    return frames.reshape((L, N, T) + frames.shape[1:])
