"""Model summaries: parameter counts per tensor (port of
`vae_gp_ode_tpu/utils/summary.py`).

A tree is an `nn.Module` (its parameters), an object with
`named_parameters()` (such as `gp.svgp.SVGPParams`), or a mapping of names
to tensors. Paths join the names' parts with '/'.
"""

import numpy as np


def _named(tree):
    if hasattr(tree, 'named_parameters'):
        return list(tree.named_parameters())
    return list(tree.items())


def param_count(tree):
    return sum(int(np.prod(t.shape)) for _, t in _named(tree))


def summarize(tree, name='model'):
    """Return a printable table of '<path>  <shape>  <count>' lines and a
    TOTAL line."""
    lines = [f'--- {name} ---']
    total = 0
    for path, t in _named(tree):
        shape = tuple(t.shape)
        n = int(np.prod(shape))
        total += n
        lines.append(f'{path.replace(".", "/"):60s} {str(shape):18s} '
                     f'{n:>10,d}')
    lines.append(f'{"TOTAL":60s} {"":18s} {total:>10,d}')
    return '\n'.join(lines)


def print_summary(model, gp=None, log=print):
    """Print the VAE's (and, given, the GP's) parameter summaries."""
    log(summarize(model, 'vae params'))
    if gp is not None:
        log(summarize(gp, 'gp params'))
