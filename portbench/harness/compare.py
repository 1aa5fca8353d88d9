"""The numbers that decide `correct`, each the widest of its kind:

training (the first three steps of the run, program against the plain
reference from the same state, batches and noise):
  loss_gap    max over the steps of |loss_p - loss_r| / |loss_r|
  terms_gap   the same over the ELBO's terms (nll, kl_reg, kl_u)
  grad_gap    the first gradient as Adam holds it after step 1
              ((mu_1 - b1 mu_0) / (1 - b1)), by the worst leaf:
              | |g_p| - |g_r| | / max(|g_r|, the median leaf's |g_r|)
  change_gap  the leaves' change over the three steps, by the worst
              leaf, as grad_gap; leaves whose reference gradient at
              step 1 is under a thousandth of the median leaf's are left
              out (their change is Adam's round-off)

forecasts (a sample of the window's requests):
  frames_gap  max |frame_p - frame_r| over every frame of every draw

A non-finite number reads as infinity.
"""

import math
import statistics

import torch

B1 = 0.9
GRAD_FLOOR = 1e-3


def _finite(x):
    return x if math.isfinite(x) else math.inf


def _leaf_gaps(got, ref, names):
    """{leaf: | |got| - |ref| | / max(|ref|, the median leaf's |ref|)}."""
    norms = {n: float(torch.linalg.vector_norm(ref[n].double()))
             for n in names}
    med = statistics.median(norms.values())
    return {n: _finite(abs(float(torch.linalg.vector_norm(got[n].double()))
                           - norms[n]) / max(norms[n], med)) for n in names}


def _worst(gaps):
    """(the widest gap, its leaf)."""
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def train_numbers(prog, ref, p0, adam0):
    """prog: {'steps': [{'loss', 'nll', 'kl_reg', 'kl_u'}] (3 steps),
    'mu1': {name: Adam's first moment after step 1}, 'p3': {name: leaves
    after step 3}}; ref: {'steps', 'p3'} as `reference.model.train_steps`
    returns them (its per-step grads give the first gradient); p0 and
    adam0: the leaves and Adam's first moments both sides started from.
    Returns the four numbers and the leaves left out of change_gap."""
    loss_gap = terms_gap = 0.0
    worst_term = None
    for i, (p, r) in enumerate(zip(prog['steps'], ref['steps'])):
        loss_gap = max(loss_gap, _finite(abs(p['loss'] - r['loss'])
                                         / abs(r['loss'])))
        for k in ('nll', 'kl_reg', 'kl_u'):
            gap = _finite(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30))
            if gap >= terms_gap:
                terms_gap, worst_term = gap, f'{k} at step {i + 1}'
    g_ref = ref['steps'][0]['grads']
    names = list(g_ref)
    g_prog = {n: (prog['mu1'][n].double() - B1 * adam0[n].double()) / (1 - B1)
              for n in names}
    grad_gap, grad_leaf = _worst(_leaf_gaps(g_prog, g_ref, names))
    gnorm = {n: float(torch.linalg.vector_norm(g_ref[n].double()))
             for n in names}
    med = statistics.median(gnorm.values())
    moving = [n for n in names if gnorm[n] >= GRAD_FLOOR * med]
    d_prog = {n: prog['p3'][n].double() - p0[n].double() for n in moving}
    d_ref = {n: ref['p3'][n].double() - p0[n].double() for n in moving}
    change_gap, change_leaf = _worst(_leaf_gaps(d_prog, d_ref, moving))
    return {'loss_gap': loss_gap, 'terms_gap': terms_gap,
            'grad_gap': grad_gap, 'change_gap': change_gap,
            'worst_term': worst_term,
            'worst_grad_leaf': grad_leaf, 'worst_change_leaf': change_leaf,
            'left_out': sorted(set(names) - set(moving))}


def frames_gap(got, ref):
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got - ref).abs().max())


def judge(numbers, limits):
    """(correct, checks): every number at or under its limit; checks maps
    each name to [number, limit]."""
    checks = {k: [numbers[k], limits[k]['limit']] for k in limits}
    return all(v <= lim for v, lim in checks.values()), checks
