"""The decomposition of the grid-tiled DF pair (kernels #11/#12,
`csrc/df_pathwise_tiled_fwd.cu` / `df_pathwise_tiled_bwd.cu`) on the CPU.

A CUDA kernel cannot run here, so each kernel's decomposition is emulated
in plain PyTorch: the partial that every block writes, at the place the
kernel writes it (the forward's slab part (L, n_slots, N, D); the VJP's
dx_slab (L, n_mc + n_chunks, N, D), its update slab (L, n_rt, 2 M D +
n_mc (D^2 + D)) and the per-draw domf, dphf, dG), computed with the
kernels' own per-(row, inducing point, output pair) formulas, and then
the sums that each library's second kernel takes of them, in the slab
layouts the wrapper sizes (`fwd_slots`, `bwd_layout`). The result is held
against
`df_pathwise_reference`, autograd through it, and the JAX package's tiled
Pallas kernels in interpret mode, at D = 1, 6, 7, 12 and 16, with feature
columns and inducing points that leave ragged last chunks, N = 1 and 20,
L = 1 and 5, and GP operands shared by the draws or per draw.
Tolerances, those of tests/test_torch_tiled.py: outputs 2e-5 abs + 2e-4
rel; cotangents 1e-5 abs + 2e-3 rel (the JAX tests' own for the DF
kernels).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gp_ode_tpu.ops.df_pathwise_tiled import (
    tiled_df_pathwise_eval as jax_tiled_df)

from vae_gp_ode_tpu_torch.ops import df_pathwise
from vae_gp_ode_tpu_torch.ops import df_pathwise_tiled as tdpt
import torch_threads  # noqa: F401

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
VJP_TOL = dict(rtol=2e-3, atol=1e-5)
NAMES = ('x',) + tdpt.NAMES
FWD_ROWS = 8          # csrc/df_pathwise_tiled_fwd.cu kRows
BWD_ROWS = 8          # csrc/df_pathwise_tiled_bwd.cu kRows (chunk blocks)


def _operands(rng, L, N, S, M, D, per_draw):
    """(x, omf, phf, G, Z, nur, ls2, var) as the JAX tests draw them, x and
    the sample's operands per draw; Z, ls2 and var per draw or shared. The
    DF gram is not formed here, so ls2 may vary by pair."""
    f = np.float32
    SD = S * D
    gp = (L,) if per_draw else ()
    return [torch.as_tensor(a) for a in (
        (rng.standard_normal((L, N, D)) * 0.5).astype(f),
        rng.standard_normal((L, D, SD)).astype(f),
        (rng.random((L, 1, SD)) * 6.28).astype(f),
        (rng.standard_normal((L, 2 * SD, D)) * 0.3).astype(f),
        rng.standard_normal(gp + (M, D)).astype(f),
        (rng.standard_normal((L, M, D)) * 0.1).astype(f),
        rng.uniform(0.8, 3.0, gp + (D, D)).astype(f),
        rng.uniform(0.3, 1.0, gp + (D,)).astype(f))]


def _draw(t, nd, l):
    """Draw l of an operand with `nd` trailing dims (shared: itself)."""
    return t[l] if t.dim() > nd else t


def _update_terms(x, z, nur, ls2, var):
    """The update blocks' per-(row, point, output pair) quantities, as the
    kernels form them: d (r, m, D), r2 (r, m), iv (j, i), E, base and c1
    (r, m, j, i)."""
    D = x.shape[-1]
    d = x[:, None, :] - z[None, :, :]
    sq = (d * d).sum(-1)
    iv = 1.0 / ls2
    E = torch.exp(-0.5 * sq[..., None, None] * iv)
    eye = torch.eye(D, dtype=x.dtype)
    base = (d[..., :, None] * d[..., None, :] * iv
            + eye * ((D - 1.0) - sq[..., None, None] * iv))
    return d, sq, iv, E, base, var[None, :] * iv


def emulate_fwd(x, operands):
    """#11's slab part, block by block, and its sum over the slots (the
    library's second kernel)."""
    omf, phf, G, Z, nur, ls2, var = operands
    L, N, D = x.shape
    SD, M = omf.shape[-1], Z.shape[-2]
    n_mc = -(-M // tdpt.FWD_UPD_M)
    assert tdpt.fwd_slots(SD, M, D) == n_mc + -(-SD // tdpt.FWD_CHUNK)
    part = torch.full((L, tdpt.fwd_slots(SD, M, D), N, D), float('nan'))
    for l in range(L):
        om, ph, g = omf[l], phf[l], G[l]
        z, nu = _draw(Z, 2, l), nur[l]
        l2, v = _draw(ls2, 2, l), _draw(var, 1, l)
        for r0 in range(0, N, FWD_ROWS):
            xr = x[l, r0:r0 + FWD_ROWS]
            # update blocks: every (j, i) pair of a (row, point) at once
            for mc, m0 in enumerate(range(0, M, tdpt.FWD_UPD_M)):
                ms = slice(m0, m0 + tdpt.FWD_UPD_M)
                _, _, _, E, base, c1 = _update_terms(xr, z[ms], nu[ms], l2,
                                                     v)
                part[l, mc, r0:r0 + FWD_ROWS] = torch.einsum(
                    'rmji,mj->ri', E * base * c1, nu[ms])
            # chunk blocks: one sincos per (row, column), all D columns
            for ch, c0 in enumerate(range(0, SD, tdpt.FWD_CHUNK)):
                cs = slice(c0, c0 + tdpt.FWD_CHUNK)
                u = xr @ om[:, cs] + ph[:, cs]
                part[l, n_mc + ch, r0:r0 + FWD_ROWS] = (
                    torch.cos(u) @ g[:SD][cs] + torch.sin(u) @ g[SD:][cs])
    assert not torch.isnan(part).any()         # every entry written
    return part.sum(dim=1)


def emulate_bwd(x, operands, gbar):
    """#12's slabs, block by block, and the finishing kernel's sums of
    them (over slots, row tiles, point chunks, and the draws of an operand
    they share), the rest as the wrapper returns it."""
    omf, phf, G, Z, nur, ls2, var = operands
    L, N, D = x.shape
    SD, M = omf.shape[-1], Z.shape[-2]
    n_chunks, n_mc, n_rt = tdpt.bwd_layout(N, D, SD, M)
    MU = tdpt.THREADS // D
    nan = float('nan')
    dx_slab = torch.full((L, n_mc + n_chunks, N, D), nan)
    upd = torch.full((L, n_rt, 2 * M * D + n_mc * (D * D + D)), nan)
    domf, dphf = torch.full((L, D, SD), nan), torch.full((L, 1, SD), nan)
    dG = torch.full((L, 2 * SD, D), nan)
    eye = torch.eye(D)
    for l in range(L):
        om, ph, g, nu = omf[l], phf[l], G[l], nur[l]
        z, l2, v = _draw(Z, 2, l), _draw(ls2, 2, l), _draw(var, 1, l)
        # update blocks (row tile rt, point chunk mc): thread (m, i) walks
        # the tile's rows and the D columns j
        for rt in range(n_rt):
            r0 = rt * tdpt.BWD_UPD_ROWS
            rs = slice(r0, r0 + tdpt.BWD_UPD_ROWS)
            gi = gbar[l, rs][:, None, None, :]              # (r, 1, 1, i)
            for mc in range(n_mc):
                ms = slice(mc * MU, (mc + 1) * MU)
                d, sq, iv, E, base, c1 = _update_terms(x[l, rs], z[ms],
                                                       nu[ms], l2, v)
                contrib = E * base * c1                     # (r, m, j, i)
                nuj = nu[ms][None, :, :, None]
                dcon = gi * nuj
                Eb, bb, cb = dcon * base * c1, dcon * E * c1, dcon * E * base
                sq4 = sq[..., None, None]
                sqb = ((Eb * E * (-0.5 * iv)).sum((-2, -1))
                       - (bb * iv * eye).sum((-2, -1)))
                ivb = (-0.5 * Eb * E * sq4
                       + bb * d[..., :, None] * d[..., None, :]
                       + cb * v - bb * sq4 * eye)
                dd = ((bb * d[..., None, :] * iv).sum(-1)       # dd[j]
                      + (bb * d[..., :, None] * iv).sum(-2))    # ddi, k = i
                t = 2 * d * sqb[..., None] + dd                 # (r, m, k)
                n_r = t.shape[0]
                dx_slab[l, mc, r0:r0 + n_r] = t.sum(1)
                out = upd[l, rt]
                m0, cnt = mc * MU, t.shape[1]
                out[m0 * D:(m0 + cnt) * D] = -t.sum(0).reshape(-1)
                out[M * D + m0 * D:M * D + (m0 + cnt) * D] = (
                    contrib * gi).sum((0, 3)).reshape(-1)
                dpar = out[2 * M * D + mc * (D * D + D):][:D * D + D]
                dpar[:D * D] = (-(ivb * iv * iv).sum((0, 1))).reshape(-1)
                dpar[D * D:] = (cb * iv).sum((0, 1, 2))
        # chunk blocks: all rows of kChunk columns, one sincos per (row,
        # column); dx = du . omf^T over the chunk's columns
        for ch in range(n_chunks):
            cs = slice(ch * tdpt.BWD_CHUNK, (ch + 1) * tdpt.BWD_CHUNK)
            u = x[l] @ om[:, cs] + ph[:, cs]
            sn, co = torch.sin(u), torch.cos(u)
            dc, ds = gbar[l] @ g[:SD][cs].T, gbar[l] @ g[SD:][cs].T
            du = co * ds - sn * dc                          # (N, c)
            dphf[l, 0, cs] = du.sum(0)
            domf[l, :, cs] = x[l].T @ du
            dG[l, :SD][cs] = co.T @ gbar[l]
            dG[l, SD:][cs] = sn.T @ gbar[l]
            for t0 in range(0, N, BWD_ROWS):
                ts = slice(t0, t0 + BWD_ROWS)
                dx_slab[l, n_mc + ch, ts] = du[ts] @ om[:, cs].T
    for t in (dx_slab, upd, domf, dphf, dG):
        assert not torch.isnan(t).any()         # every entry written
    MD = M * D
    u = upd.sum(dim=1)
    dpar = u[:, 2 * MD:].reshape(L, n_mc, D * D + D).sum(dim=1)
    finished = (u[:, :MD].reshape(L, M, D), u[:, MD:2 * MD].reshape(L, M, D),
                dpar[:, :D * D].reshape(L, D, D), dpar[:, D * D:])
    return (dx_slab.sum(dim=1),) + tuple(
        bar if t.dim() == bar.dim() else bar.sum(dim=0)
        for t, bar in zip(operands, (domf, dphf, dG) + finished))


# (L, N, S, M, D, per-draw GP operands): D = 1, 6, 7, 12, 16; S*D past one
# 256-column chunk with a ragged last one; M past one point chunk of the
# forward (16) and of the VJP (256 // D) with a ragged last one
CASES = [(1, 1, 300, 17, 1, False), (5, 20, 45, 50, 6, False),
         (1, 20, 40, 37, 7, True), (5, 20, 24, 23, 12, False),
         (1, 20, 17, 20, 16, False), (5, 1, 22, 9, 12, True),
         (1, 20, 24, 45, 12, True)]


def _jax_draws(fn, args, per_draw):
    axes = (0,) * 8 if per_draw else (0, 0, 0, 0, None, 0, None, None)
    return jax.vmap(fn, in_axes=axes)(*map(jnp.asarray, args))


@pytest.mark.parametrize('L,N,S,M,D,per_draw', CASES)
def test_fwd_decomposition(L, N, S, M, D, per_draw):
    """#11's per-block partials summed as the wrapper sums them: the
    plain version and the JAX tiled kernel (two ORFF chunks)."""
    x, *ops_ = _operands(np.random.default_rng(40 + D), L, N, S, M, D,
                         per_draw)
    out = emulate_fwd(x, ops_)
    ref = df_pathwise.df_pathwise_reference(x, *ops_)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **FWD_TOL)
    sd_tile = S * D // 2 if S * D % 2 == 0 else None
    jref = _jax_draws(lambda *a: jax_tiled_df(*a, interpret=True,
                                              sd_tile=sd_tile),
                      [x] + ops_, per_draw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), **FWD_TOL)


@pytest.mark.parametrize('L,N,S,M,D,per_draw', CASES)
def test_vjp_decomposition(L, N, S, M, D, per_draw):
    """#12's per-block partials (the update term split over row tiles and
    point chunks, the prior over column chunks) summed as the wrapper
    sums them: every cotangent against autograd through the plain
    version and against the JAX tiled kernel's VJP."""
    args = _operands(np.random.default_rng(50 + D), L, N, S, M, D,
                     per_draw)
    x, *ops_ = args
    gbar = torch.as_tensor(np.random.default_rng(60 + D).standard_normal(
        (L, N, D)).astype(np.float32))
    mine = emulate_bwd(x, ops_, gbar)
    ref = df_pathwise.df_pathwise_vjp_reference(x, *ops_, gbar)
    for name, a, b in zip(NAMES, mine, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                   **VJP_TOL)
    fn = (lambda *a: _jax_draws(lambda *b: jax_tiled_df(
        *b, interpret=True), a, per_draw))
    _, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    for name, a, b in zip(NAMES, mine, vjp(jnp.asarray(gbar.numpy()))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **VJP_TOL)


def test_layouts():
    """The slabs' sizes at the shapes the paths launch the pair at (the
    C launchers refuse any other layout); above D = 16 the forward's
    update blocks take 256 // D points (D = 20: 12, D = 64: 4), above D =
    256 one; the VJP's chunk blocks give a feature column ceil(D / 8)
    threads, so take 256 // ceil(D / 8) columns (D = 64: 32)."""
    assert tdpt.fwd_slots(12288, 100, 12) == 7 + 48
    assert tdpt.fwd_slots(1536, 100, 6) == 7 + 6
    assert tdpt.fwd_slots(5120, 100, 20) == 9 + 20
    assert tdpt.fwd_slots(16384, 100, 64) == 25 + 64
    assert tdpt.fwd_slots(1040, 10, 260) == 10 + 5
    assert tdpt.bwd_layout(20, 64, 16384, 100) == (512, 25, 5)
    assert tdpt.bwd_layout(20, 12, 12288, 100) == (48, 5, 5)
    assert tdpt.bwd_layout(20, 6, 1536, 100) == (6, 3, 5)
    assert tdpt.bwd_layout(1, 16, 1, 1) == (1, 1, 1)


def test_launch_counts_split_by_shape(monkeypatch):
    """`ops.count` adds one launch to the kernel's count and to its count at
    the shape key; `reset_launches` clears both (chip_smoke.py reads the
    split per path run)."""
    from vae_gp_ode_tpu_torch import ops
    monkeypatch.setattr(ops, 'LAUNCHES', dict.fromkeys(ops.LAUNCHES, 0))
    monkeypatch.setattr(ops, 'SHAPES', type(ops.SHAPES)())
    for shape in ((5, 20, 12, 12288, 100), (5, 20, 12, 12288, 100),
                  (1, 400, 12, 12288, 100)):
        ops.count(tdpt.KERNEL, shape)
    assert ops.LAUNCHES[tdpt.KERNEL] == 3
    assert dict(ops.SHAPES) == {
        (tdpt.KERNEL, (5, 20, 12, 12288, 100)): 2,
        (tdpt.KERNEL, (1, 400, 12, 12288, 100)): 1}
    ops.reset_launches()
    assert not any(ops.LAUNCHES.values()) and not ops.SHAPES
