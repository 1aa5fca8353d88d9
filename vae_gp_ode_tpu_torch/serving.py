"""Serving: the eval-mode forecaster, a trained run's state, and the
serving artifact (port of `vae_gp_ode_tpu/serving.py`).

The artifact is a `torch.export` program of the forecaster, saved with
`torch.export.save`, that

  * bakes the trained weights in (the VAE's and the GP's tensors are the
    program's state): serving needs torch and the port's `ops` package,
    which registers the kernels' operators, not the model code;
  * runs in eval mode (BatchNorm's running statistics);
  * launches the hand-written forward kernels: the euler trajectory (#1,
    or #7 for the divergence-free kernel), the per-step evals (#3 or #9,
    #5 or #11, chosen on the shapes of each call) and bdf's Newton
    Jacobians (a VJP kernel, #4 or #10, #6 or #12) are registered
    operators (`ops.library`), which the trace keeps as calls;
  * takes ``(X, *noise)``: `torch.export` cannot carry a
    `torch.Generator`, so the raw noise of the z0 reparameterisation and
    of the L pathwise GP draws is an input, drawn by `Forecaster` from a
    seed on the serving device in the order the model draws it;
  * may have a symbolic batch dimension ('b'), so that one artifact
    serves any number of sequences;
  * names the devices it may be served on (`platforms`): an artifact
    exported on the CPU moves to the card at load time.

The JAX package traces its artifact without its Pallas kernels and
substitutes its LAPACK calls; here the kernels are the point, and
PyTorch's Cholesky and triangular solves serialise as they are.

CLI:  python -m vae_gp_ode_tpu_torch.serving --model_path <run> \\
          --out forecaster.pt2 [--L 5] [--Troll 2] [--batch 0] \\
          [--dtype bf16] [--platforms cpu cuda] [--device cuda]
"""

import contextlib
import copy
import json
import os
import types

import torch
from torch import nn

from vae_gp_ode_tpu_torch.core.device import resolve_device

#: rot-MNIST normalisation (reference data/utils.py)
MNIST_MEAN = 0.1307
MNIST_STD = 0.3081
_IMG = 28  # rot-MNIST frames are 28x28

#: the VAE compute types of `make_forecast_fn(dtype=)`
DTYPES = {'f32': None, 'bf16': torch.bfloat16}
FORMAT = 'vae_gp_ode_tpu_torch.export'
MANIFEST_VERSION = 1
#: the file inside the artifact that carries its noise spec, platforms and
#: input/output specs (so that it serves without its manifest too)
_META = 'forecaster.json'
_DRAWS = {'normal': torch.randn, 'uniform': torch.rand}


def _check_choices(mc_reduce, dtype):
    if mc_reduce not in ('none', 'mean'):
        raise ValueError(f'mc_reduce must be none|mean, got {mc_reduce!r}')
    if dtype not in DTYPES:
        raise ValueError(f'dtype must be f32|bf16, got {dtype!r}')


def _prepare(model, params, gp, device, settings=()):
    """Load `params` into `model`, set its solver `settings` (name, value;
    None keeps the model's), move it and `gp` to `device` and put the
    model in eval mode. Returns (device, model, gp)."""
    dev = resolve_device(device)
    if params is not None:
        model.load_state_dict(params)
    for name, value in settings:
        if value is not None:
            setattr(model, name, value)
    model.to(dev).eval()
    return dev, model, gp.to(dev)


def make_forecast_fn(model, params, gp, *, L=1, T_custom=None,
                     mc_reduce='none', normalize_input=False, dtype='f32',
                     solver=None, dense=None, rtol=None, atol=None,
                     max_steps=None, device='cuda'):
    """Close a trained (model, params, gp) over ``fn(X, seed) -> Xrec``.

    params: a state dict for `model` (e.g. from utils.jax_import.from_jax),
    or None to keep the model's own weights. gp: the SVGP of either kernel
    (RBF with dimwise or shared lengthscales, or DF as in a run restored by
    `training.checkpoint.restore_jax_checkpoint`). The model and gp move to
    `device` (default the GPU; raises if it is absent) and the model is
    put in eval mode: BatchNorm uses its running statistics.

    X: (N, T, 1, d, d) sequences in the model's input normalisation, or
    raw [0, 1] pixels with normalize_input=True, which applies
    ``(x - 0.1307) / 0.3081`` first.
    seed: an int; seeds the `torch.Generator` on the device that draws the
    z0 reparameterisation and the L pathwise GP functions. `noise=` (the
    model's noise dict, `forecast_noise`) replaces those draws.

    mc_reduce: 'none' -> Xrec (L, N, T, 1, d, d), all MC samples;
               'mean' -> Xrec (N, T, 1, d, d), their mean.

    dtype: 'f32' or 'bf16': the encoders and the decoder compute in
    bfloat16 on a copy of the model (`ODEGPVAE.with_dtype`), while the
    GP, the ODE and the returned frames stay float32.

    solver, dense, rtol, atol, max_steps: the ODE solver settings of the
    forecast, which are the model's fields (`ODEGPVAE`; the JAX package
    sets them when it builds its model, `init_model(solver=...)`); a
    value given here is set on the model, None keeps the model's.
    """
    _check_choices(mc_reduce, dtype)
    dev, model, gp = _prepare(model, params, gp, device, (
        ('solver', solver), ('dense', dense), ('rtol', rtol),
        ('atol', atol), ('max_steps', max_steps)))
    if DTYPES[dtype] is not None:
        model = model.with_dtype(DTYPES[dtype])

    def fn(X, seed, noise=None):
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        if normalize_input:
            X = (X - MNIST_MEAN) / MNIST_STD
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
        with torch.no_grad():
            Xrec, _, _, _ = model(X, gp, L=L, T_custom=T_custom,
                                  generator=generator, noise=noise)
        if mc_reduce == 'mean':
            Xrec = torch.mean(Xrec, dim=0)
        return Xrec.float()

    return fn


# -- the raw noise of a request -----------------------------------------------

def noise_spec(model, gp, L):
    """The raw noise of one request in the order the model draws it (z0,
    v0 for order 2, then the L GP draws' omega, phase_u, weights and
    epsilon; `models/odegpvae.py`): a list of [name, shape, draw], shape
    with None for the batch of sequences, draw 'normal' or 'uniform'."""
    q = model.latent_dim
    spec = [['z0', [None, q], 'normal']]
    if model.order == 2:
        spec.append(['v0', [None, q], 'normal'])
    S, df = model.num_features, gp.kernel_name == 'DF'
    per_dim = [gp.D_out] if df or gp.kernel.dimwise else []
    spec += [['omega', [L, gp.D_in, S] + per_dim, 'normal'],
             ['phase_u', [L, 1, S] + per_dim, 'uniform'],
             ['weights', [L, 2 * S if df else S, gp.D_out], 'normal'],
             ['epsilon', [L, gp.M, gp.D_out], 'normal']]
    return spec


def draw_noise(spec, N, generator, device):
    """The noise dict of `spec` for N sequences, drawn in order from
    `generator` on `device` (float32)."""
    return {name: _DRAWS[draw](tuple(N if d is None else d for d in shape),
                               generator=generator, dtype=torch.float32,
                               device=device)
            for name, shape, draw in spec}


def forecast_noise(gp, model, N, L, generator):
    """The raw noise dict that the model's forward draws from `generator`
    for N sequences and L draws, in the same order: the model given it
    as `noise=` gives the frames it gives with the generator."""
    return draw_noise(noise_spec(model, gp, L), N, generator,
                      gp.Um.device)


# -- the artifact -------------------------------------------------------------

class _Program(nn.Module):
    """What `export_forecaster` traces: the forecast of a frozen eval-mode
    model on ``(X, *noise)``, with the GP's tensors as buffers (the
    program's state, as the model's weights are)."""

    def __init__(self, model, gp, names, L, T_custom, mc_reduce,
                 normalize_input):
        super().__init__()
        self.model = model.requires_grad_(False)
        for name, t in gp.named_parameters():
            self.register_buffer(name.replace('.', '_'), t.detach().clone())
        self.static = dict(q_diag=gp.q_diag, kernel_name=gp.kernel_name)
        self.names = tuple(names)
        self.L, self.T_custom = L, T_custom
        self.mc_reduce, self.normalize_input = mc_reduce, normalize_input

    def gp(self):
        from vae_gp_ode_tpu_torch.gp.svgp import SVGPParams
        from vae_gp_ode_tpu_torch.kernels.rbf import RBFParams
        kernel = RBFParams(self.kernel_unconstrained_lengthscales,
                           self.kernel_unconstrained_variance)
        return SVGPParams(kernel=kernel, inducing_loc=self.inducing_loc,
                          Um=self.Um, Us_sqrt=self.Us_sqrt, **self.static)

    def forward(self, X, *noise):
        if self.normalize_input:
            X = (X - MNIST_MEAN) / MNIST_STD
        Xrec, _, _, _ = self.model(X, self.gp(), L=self.L,
                                   T_custom=self.T_custom,
                                   noise=dict(zip(self.names, noise)))
        if self.mc_reduce == 'mean':
            Xrec = torch.mean(Xrec, dim=0)
        return Xrec.float()


def _specs(nodes):
    """[{'name', 'shape', 'dtype'}] of graph nodes' values, a symbolic
    dim as 'b'."""
    return [{'name': n.name,
             'shape': [str(d) if isinstance(d, int) else 'b'
                       for d in n.meta['val'].shape],
             'dtype': str(n.meta['val'].dtype).replace('torch.', '')}
            for n in nodes]


@contextlib.contextmanager
def _no_stack_traces():
    """No source stack traces in a traced program's nodes, where this
    torch can leave them out (`torch.fx.config.do_not_emit_stack_traces`):
    they cost a fifth of the trace time and of the artifact's bytes, and
    serving reads none."""
    config = torch.fx.config
    if not hasattr(config, 'do_not_emit_stack_traces'):
        yield
        return
    emit, config.do_not_emit_stack_traces = (
        config.do_not_emit_stack_traces, True)
    try:
        yield
    finally:
        config.do_not_emit_stack_traces = emit


def _platforms(platforms, dev):
    plats = [dev.type] if platforms is None else [str(p) for p in platforms]
    bad = [p for p in plats if p not in ('cpu', 'cuda')]
    if bad or not plats:
        raise ValueError(f'platforms must be cpu and/or cuda, got {plats}')
    return plats


def export_forecaster(model, params, gp, *, T, img=_IMG, batch=None, L=1,
                      T_custom=None, mc_reduce='none',
                      normalize_input=False, platforms=None, dtype='f32',
                      device='cuda'):
    """Export the forecaster of (model, params, gp) as a `Forecaster`
    around a `torch.export.ExportedProgram`, traced on `device` (default
    the GPU; raises if it is absent) on a copy of the model in eval mode,
    with its weights and the GP's tensors baked in.

    T: the input horizon (frames the encoder sees); T_custom, if set, the
    output horizon (a rollout past the input). batch: the serving batch
    size; None exports a symbolic batch dim ('b', any N >= 1).
    L, mc_reduce, normalize_input, dtype: as `make_forecast_fn`'s; the
    solver settings are the model's fields. platforms: the devices the
    artifact may be served on ('cpu', 'cuda'); None: `device`'s only.

    The program takes ``(X, *noise)``, the noise in `noise_spec` order.
    The forward kernels are the operators of `ops.library`; where the
    trace runs on the CPU it takes the fused euler pair at every shape, so
    `load_forecaster` checks the shapes again on the card. bdf's Newton
    Jacobians are the Jacobian operators (`pathwise_eval_jac`,
    `df_pathwise_eval_jac`: one VJP kernel launch each on the card), so a
    bdf forecaster exports on either device, for either, with a symbolic
    batch like any other (meta 'plain_evals' false: no plain per-step eval
    in the program).
    """
    _check_choices(mc_reduce, dtype)
    dev, model, gp = _prepare(copy.deepcopy(model), params, gp, device)
    if DTYPES[dtype] is not None:
        model = model.with_dtype(DTYPES[dtype])
    plats = _platforms(platforms, dev)
    spec = noise_spec(model, gp, L)
    names = [name for name, _, _ in spec]
    prog = _Program(model, gp, names, L, T_custom, mc_reduce,
                    normalize_input)
    n = 2 if batch is None else batch
    X = torch.zeros((n, T, 1, img, img), device=dev)
    noise = {name: torch.zeros(tuple(n if d is None else d for d in shape),
                               device=dev) for name, shape, _ in spec}
    dynamic = None
    if batch is None:
        # the trace refines the batch's range where an operation bounds it
        # (on the card, cuDNN's 32-bit indexing: `max_batch`)
        b = torch.export.Dim.AUTO
        dynamic = ({0: b}, tuple({0: b} if shape[0] is None else None
                                 for _, shape, _ in spec))
    with torch.no_grad(), _no_stack_traces():
        program = torch.export.export(
            prog, (X,) + tuple(noise[name] for name in names),
            dynamic_shapes=dynamic)
    placeholders = {n.name: n for n in program.graph.nodes
                    if n.op == 'placeholder'}
    outputs = next(n for n in program.graph.nodes if n.op == 'output')
    meta = {'noise_spec': spec, 'platforms': plats, 'dtype': dtype,
            'solver': model.solver, 'plain_evals': False,
            'in_specs': _specs(placeholders[name] for name in
                               program.graph_signature.user_inputs),
            'out_specs': _specs(outputs.args[0]),
            'max_batch': batch or _max_batch(program)}
    return Forecaster(program, meta)


def _max_batch(program):
    """The most sequences a symbolic batch takes: the upper end of the
    range the trace left on it, None where it is unbounded."""
    hi = max((r.upper for r in program.range_constraints.values()),
             default=None)
    return None if hi is None or not hi < 2 ** 62 else int(hi)


class Forecaster:
    """A callable around an exported forecaster and its `meta` (noise
    spec, platforms, dtype and the input and output specs)."""

    def __init__(self, program, meta, manifest=None):
        self.program = program
        self.meta = meta
        self.manifest = manifest   # the sidecar's provenance (may be None)
        self._module = program.module()

    @property
    def input_shape(self):
        """The shape of X: ints, with 'b' for a symbolic batch."""
        return tuple(d if d == 'b' else int(d)
                     for d in self.meta['in_specs'][0]['shape'])

    @property
    def platforms(self):
        return tuple(self.meta['platforms'])

    @property
    def device(self):
        """The device of the program's state (weights)."""
        return next(iter(self.program.state_dict.values())).device

    def call(self, X, noise):
        """The program on X and a noise dict (as `forecast_noise` gives
        it) on the program's device."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            return self._module(X, *(
                torch.as_tensor(noise[name], device=self.device)
                for name, _, _ in self.meta['noise_spec']))

    def __call__(self, X, seed=0):
        """Frames for X from the noise that a `torch.Generator` on the
        program's device, seeded with `seed`, draws."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(seed))
        noise = draw_noise(self.meta['noise_spec'], X.shape[0], generator,
                           self.device)
        return self.call(X, noise)


def _manifest_path(path):
    return f'{path}.manifest.json'


def save_forecaster(forecaster, path):
    """Save a `Forecaster` to a standalone file (`torch.export.save`,
    with its meta inside), plus a sidecar manifest
    (``<path>.manifest.json``: torch version, platforms, input, output and
    noise specs, dtype, size and the operators' namespace) so that a
    mismatched serving host fails with provenance. Returns the file's
    size in bytes."""
    from vae_gp_ode_tpu_torch.ops import library
    torch.export.save(forecaster.program, path,
                      extra_files={_META: json.dumps(forecaster.meta)})
    nbytes = os.path.getsize(path)
    manifest = {'format': FORMAT, 'manifest_version': MANIFEST_VERSION,
                'torch_version': torch.__version__,
                'op_namespace': library.NAMESPACE, **forecaster.meta,
                'nbytes': nbytes}
    with open(_manifest_path(path), 'w') as f:
        json.dump(manifest, f, indent=1)
    return nbytes


def _fused_shapes_fit(program, dev):
    """Raise unless every fused euler trajectory of `program` is one that
    the fused pair takes on CUDA `dev` (`ops.library.pair_refusal`): a
    trace on the CPU takes the pair at every shape."""
    from vae_gp_ode_tpu_torch.ops import library
    for node in program.graph.nodes:
        what = library.pair_refusal(node, dev)
        if what is not None:
            raise RuntimeError(
                f'the artifact runs the fused euler trajectory ({node.target}'
                f') at {what}, which the fused pair does not take on '
                f'{torch.cuda.get_device_name(dev)}: export it on the card '
                f'(--device cuda), where the flow takes the per-step '
                f'kernels')


def load_forecaster(path, device='cuda', check_platform=True):
    """Load a saved artifact as a `Forecaster` on `device` (default the
    GPU; raises if it is absent; float32 convolutions and matmuls pinned
    to full precision as `core.device.resolve_device` does).

    Importing `ops.library` registers the kernels' operators. The program
    moves to `device` (`torch.export.passes.move_to_device_pass`). On the
    card the fused euler trajectories of a program traced on the CPU are
    checked against the pair's rule (an error names a shape it refuses),
    and a program whose trace holds plain per-step evals (meta
    'plain_evals': a bdf forecaster traced on the CPU before its Newton
    Jacobians became operators, whose plain evals would run on the card
    unnoticed) raises naming its solver.

    With the sidecar manifest of :func:`save_forecaster`:

    * a `device` that is not among the artifact's platforms raises a
      RuntimeError naming both and pointing at ``--platforms``; pass
      ``check_platform=False`` to load anyway;
    * a file that fails to load raises a RuntimeError carrying the
      exporting torch version and this process's.

    A file without a manifest loads as before.
    """
    from vae_gp_ode_tpu_torch.ops import library  # noqa: F401 (registers)
    import torch.export.passes
    dev = resolve_device(device)
    manifest = None
    try:
        with open(_manifest_path(path)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        pass
    if manifest is not None and check_platform:
        plats = manifest.get('platforms', [])
        if plats and dev.type not in plats:
            raise RuntimeError(
                f'artifact {os.path.basename(path)!r} was exported for '
                f'platform(s) {plats} but this process serves on '
                f'{dev.type!r}. Re-export with --platforms {dev.type} (or '
                f'several platforms), or pass check_platform=False to load '
                f'anyway.')
    extra = {_META: ''}
    try:
        program = torch.export.load(path, extra_files=extra)
    except Exception as e:  # noqa: BLE001 - any load failure, with provenance
        prov = ''
        if manifest is not None:
            prov = (f' (artifact exported with torch '
                    f'{manifest.get("torch_version")}; this process runs '
                    f'torch {torch.__version__})')
        raise RuntimeError(
            f'failed to deserialize {os.path.basename(path)!r}{prov}: '
            f'{type(e).__name__}: {e}') from e
    meta = json.loads(extra[_META])
    if dev.type == 'cuda' and meta.get('plain_evals'):
        raise RuntimeError(
            f'artifact {os.path.basename(path)!r} was traced with the '
            f'{meta["solver"]} solver, whose Newton Jacobians run the '
            f'per-step evals\' plain versions: it serves on the CPU only '
            f'(device cpu), not on {dev.type!r}')
    program = torch.export.passes.move_to_device_pass(program, dev)
    if dev.type == 'cuda':
        _fused_shapes_fit(program, dev)
    return Forecaster(program, meta, manifest)


def load_run_dir(model_path, device='cuda'):
    """(model, state, args) of a training run directory: `args.json` (the
    run's flags; `dimwise` shapes the GP, `pretrained` and `fix_kernel`
    the train state) and
    `odegpvae_mnist.ckpt`, the port's own checkpoint or the JAX package's
    npz one (such as `checkpoints/df_5000ep`; the `device` its flags name
    is not read), on `device` (default the GPU; raises if it is absent).
    The dataset is not touched."""
    from vae_gp_ode_tpu_torch.models.odegpvae import init_model
    from vae_gp_ode_tpu_torch.training import checkpoint as ckpt
    from vae_gp_ode_tpu_torch.training.trainer import create_train_state

    with open(os.path.join(model_path, 'args.json')) as f:
        ta = types.SimpleNamespace(**json.load(f))
    model, gp = init_model(
        0, latent_dim=ta.latent_dim, n_filt=ta.n_filt, order=ta.ode,
        frames=ta.frames, dt=ta.dt, solver=ta.solver,
        dense=getattr(ta, 'ts_dense_scale', 1),
        num_features=ta.num_features, num_inducing=ta.num_inducing,
        kernel=ta.kernel, q_diag=ta.q_diag,
        dimwise=getattr(ta, 'dimwise', True),
        use_adjoint=getattr(ta, 'use_adjoint', False), device=device)
    state = create_train_state(
        model, gp, lr=ta.lr, fix_kernel=bool(getattr(ta, 'fix_kernel', False)),
        freeze_vae=bool(getattr(ta, 'pretrained', False)))
    path = os.path.join(model_path, 'odegpvae_mnist.ckpt')
    if ckpt.checkpoint_format(path) == 'torch':
        ckpt.restore_checkpoint(path, state)
    else:
        ckpt.restore_jax_checkpoint(path, state)
    return state.model, state, ta


def export_run_dir(model_path, out_path, *, L=1, Troll=0, batch=None,
                   mc_reduce='none', normalize_input=False, platforms=None,
                   dtype='f32', device='cuda'):
    """Export a training run directory (`load_run_dir`: the port's or the
    JAX package's) to a saved artifact at `out_path`, traced on
    `device`. Troll > 0 forecasts Troll*T frames from T input frames.
    Returns (Forecaster, bytes)."""
    model, state, ta = load_run_dir(model_path, device=device)
    fc = export_forecaster(
        model, None, state.gp, T=ta.T, batch=batch, L=L,
        T_custom=Troll * ta.T if Troll else None, mc_reduce=mc_reduce,
        normalize_input=normalize_input, platforms=platforms, dtype=dtype,
        device=device)
    return fc, save_forecaster(fc, out_path)


def _main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        'Export a trained VAE-GP-ODE run as a standalone serving artifact')
    p.add_argument('--model_path', type=str, required=True,
                   help='run dir containing odegpvae_mnist.ckpt + args.json')
    p.add_argument('--out', type=str, required=True,
                   help='output artifact path (.pt2)')
    p.add_argument('--L', type=int, default=1, help='MC samples baked in')
    p.add_argument('--Troll', type=int, default=0,
                   help='if >0, forecast Troll*T steps from T input frames')
    p.add_argument('--batch', type=int, default=0,
                   help='serving batch size (0: symbolic - any batch)')
    p.add_argument('--mc_reduce', type=str, default='none',
                   choices=['none', 'mean'])
    p.add_argument('--dtype', type=str, default='f32',
                   choices=['f32', 'bf16'],
                   help='bf16: bfloat16 encoder/decoder compute, float32 '
                        'dynamics and frames')
    p.add_argument('--normalize_input', action='store_true',
                   help='artifact takes raw [0,1] pixels and applies the '
                        'training normalisation in-graph')
    p.add_argument('--platforms', type=str, nargs='*', default=None,
                   help='devices the artifact may be served on, e.g. '
                        '--platforms cpu cuda (default: --device only)')
    p.add_argument('--device', type=str, default='cuda',
                   help='device to export on (cuda, or cpu)')
    a = p.parse_args(argv)
    fc, nbytes = export_run_dir(
        a.model_path, a.out, L=a.L, Troll=a.Troll, batch=a.batch or None,
        mc_reduce=a.mc_reduce, normalize_input=a.normalize_input,
        platforms=a.platforms, dtype=a.dtype, device=a.device)
    print(json.dumps({'out': a.out, 'bytes': nbytes,
                      'input_shape': [str(d) for d in fc.input_shape],
                      'platforms': list(fc.platforms)}))


if __name__ == '__main__':
    _main()
