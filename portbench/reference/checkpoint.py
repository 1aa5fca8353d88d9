"""Read a trained run's checkpoint with numpy alone: the npz file of the
JAX train state (`leaf_<i>` arrays in pytree order, which the file's
`__treedef__` text spells out), converted to the reference's leaf names
and layouts.

Leaf order: step; the VAE's parameters (decoder, then encoder; flax
modules and leaves in sorted order); its BatchNorm statistics; the five
SVGP leaves; Adam's count; Adam's mu and nu, each over the VAE's
parameters and the SVGP leaves.

Layouts: a flax Conv kernel (kH, kW, I, O) -> (O, I, kH, kW); a flax
ConvTranspose kernel (kH, kW, I, O), flipped in space -> (I, O, kH, kW);
a flax Dense kernel (in, out) -> (out, in), with the (h, w, c) flatten of
flax against the (c, h, w) flatten of the reference at the boundary
between convolutions and the dense layer. Adam's moments take their
parameters' layouts (each conversion moves entries, nothing more).
"""

import numpy as np

from portbench.reference.model import GP_LEAVES

_ENC = ('BatchNorm_0', 'BatchNorm_1', 'Conv_0', 'Conv_1', 'Conv_2',
        'Dense_0')
_DEC = ('BatchNorm_0', 'BatchNorm_1', 'BatchNorm_2', 'ConvTranspose_0',
        'ConvTranspose_1', 'ConvTranspose_2', 'ConvTranspose_3', 'Dense_0')
_MODULES = (('decoder', _DEC), ('encoder', _ENC))
_TARGET = {('encoder', 'Conv_0'): 'cnn.0', ('encoder', 'BatchNorm_0'): 'cnn.1',
           ('encoder', 'Conv_1'): 'cnn.3', ('encoder', 'BatchNorm_1'): 'cnn.4',
           ('encoder', 'Conv_2'): 'cnn.6', ('encoder', 'Dense_0'): 'fc',
           ('decoder', 'Dense_0'): 'fc',
           ('decoder', 'ConvTranspose_0'): 'decnn.1',
           ('decoder', 'BatchNorm_0'): 'decnn.2',
           ('decoder', 'ConvTranspose_1'): 'decnn.4',
           ('decoder', 'BatchNorm_1'): 'decnn.5',
           ('decoder', 'ConvTranspose_2'): 'decnn.7',
           ('decoder', 'BatchNorm_2'): 'decnn.8',
           ('decoder', 'ConvTranspose_3'): 'decnn.10'}


def _convert(mod, layer, leaf, a):
    """(name, array) of one flax leaf in the reference's layout."""
    name = f'{mod}.{_TARGET[mod, layer]}'
    if leaf in ('mean', 'var'):
        return f'{name}.running_{leaf}', a
    if layer.startswith('BatchNorm'):
        return f'{name}.{"weight" if leaf == "scale" else "bias"}', a
    if leaf == 'kernel':
        if layer.startswith('Conv_'):
            a = np.transpose(a, (3, 2, 0, 1))
        elif layer.startswith('ConvTranspose'):
            a = np.transpose(a[::-1, ::-1], (2, 3, 0, 1))
        elif mod == 'encoder':                     # (16 C, 2q), (h, w, c)
            C = a.shape[0] // 16
            a = a.T.reshape(-1, 4, 4, C).transpose(0, 3, 1, 2).reshape(
                a.shape[1], -1)
        else:                                      # (q, 16 C), (h, w, c)
            C = a.shape[1] // 16
            a = a.T.reshape(4, 4, C, -1).transpose(2, 0, 1, 3).reshape(
                16 * C, -1)
        return f'{name}.weight', a
    if mod == 'decoder' and layer == 'Dense_0':
        C = a.shape[0] // 16
        a = a.reshape(4, 4, C).transpose(2, 0, 1).reshape(-1)
    return f'{name}.bias', a


def _take(it, stats):
    out = {}
    for mod, layers in _MODULES:
        for layer in layers:
            if layer.startswith('BatchNorm'):
                keys = ('mean', 'var') if stats else ('bias', 'scale')
            elif stats:
                continue
            else:
                keys = ('bias', 'kernel')
            for k in keys:
                n, a = _convert(mod, layer, k, next(it))
                out[n] = np.ascontiguousarray(a, dtype=np.float32)
    return out


def _take_gp(it):
    return {n: np.asarray(next(it), dtype=np.float32) for n in GP_LEAVES}


def read_train_state(path):
    """{'step': int, 'params': {name: array} (VAE parameters and
    statistics, SVGP leaves), 'adam': {'count': int, 'mu': {name: array},
    'nu': {name: array}}} of the checkpoint at `path`."""
    with np.load(path, allow_pickle=False) as data:
        n = sum(1 for k in data.files if k.startswith('leaf_'))
        leaves = [data[f'leaf_{i}'] for i in range(n)]
    it = iter(leaves)
    step = int(next(it))
    params = _take(it, False)
    params.update(_take(it, True))
    params.update(_take_gp(it))
    adam = {'count': int(next(it))}
    for k in ('mu', 'nu'):
        adam[k] = _take(it, False)
        adam[k].update(_take_gp(it))
    if next(it, None) is not None:
        raise ValueError(f'{path} holds more leaves than a train state of '
                         f'this model')
    return {'step': step, 'params': params, 'adam': adam}
