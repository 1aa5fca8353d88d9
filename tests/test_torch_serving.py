"""The port's serving artifact (`vae_gp_ode_tpu_torch.serving`) against the
JAX package's, on the CPU at small sizes (q=3, n_filt=4, S=16, M=8, T=4,
L=2; `serving_common.py`): the exported program at the JAX forward's raw
noise against JAX `export_forecaster(...).call` and the live
`make_forecast_fn` (rtol = atol = 1e-5), seeds, a symbolic batch, the
file, its manifest and the load's errors, the run-directory export, the
CLI, a fresh process and the HTTP server. The model variants and bf16 are
in `test_torch_serving_variants.py`.
"""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from serving_common import (
    L, M, N, NF, Q, S, T, TOL, jax_noise, live, models, raw,
)
from vae_gp_ode_tpu import serving as jserving
from vae_gp_ode_tpu.training import checkpoint as jckpt
from vae_gp_ode_tpu.training.trainer import (
    create_train_state as jcreate_train_state,
)

from vae_gp_ode_tpu_torch import ops, serving
from vae_gp_ode_tpu_torch.ops import library
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def tiny():
    """The main-config family at test size: JAX and port models, and one
    port artifact with a symbolic batch (L=2, normalize_input)."""
    jm, jv, jgp, tm, tgp = models(seed=3)
    fc = serving.export_forecaster(tm, None, tgp, T=T, L=L,
                                   normalize_input=True, device='cpu')
    return jm, jv, jgp, tm, tgp, fc


# -- the program against the JAX package --------------------------------------

@pytest.mark.parametrize('mc_reduce', ['none', 'mean'])
def test_artifact_matches_jax(tiny, mc_reduce):
    """A rollout of 2T frames from T raw frames (normalize_input), at the
    JAX forward's noise: the port's program against JAX's exported
    forecaster (mc_reduce none) and its live one. The program holds the
    trajectory operator, not the plain flow."""
    jm, jv, jgp, tm, tgp, _ = tiny
    kw = dict(L=L, T_custom=2 * T, mc_reduce=mc_reduce,
              normalize_input=True)
    fc = serving.export_forecaster(tm, None, tgp, T=T, batch=N,
                                   device='cpu', **kw)
    targets = {str(n.target) for n in fc.program.graph.nodes}
    assert 'vae_gp_ode_torch.flow_fused_fwd.default' in targets
    X, seed = raw(4), 11
    out = fc.call(X, jax_noise(jax.random.PRNGKey(seed),
                                fc.meta['noise_spec'], N))
    shape = (N, 2 * T, 1, 28, 28)
    assert out.shape == (shape if mc_reduce == 'mean' else (L,) + shape)
    np.testing.assert_allclose(out.numpy(), live(jm, jv, jgp, X, seed, **kw),
                               **TOL)
    if mc_reduce == 'none':
        jex = jserving.export_forecaster(jm, jv, jgp, T=T, batch=N, **kw)
        np.testing.assert_allclose(out.numpy(),
                                   np.asarray(jex.call(X, jnp.int32(seed))),
                                   **TOL)


def test_seeded_call_matches_eager_and_batch_is_symbolic(tiny):
    """One artifact (symbolic batch 'b') serves N = 1, 2 and 5: its
    `Forecaster(X, seed)` equals the eager `make_forecast_fn(X, seed)`,
    whose model draws its own noise, and `forecast_noise` gives the
    model's draws in its order."""
    _, _, _, tm, tgp, fc = tiny
    assert fc.input_shape == ('b', T, 1, 28, 28)
    fn = serving.make_forecast_fn(tm, None, tgp, L=L, normalize_input=True,
                                  device='cpu')
    before = dict(ops.LAUNCHES)
    for n in (1, 2, 5):
        X = raw(10 + n, n)
        out = fc(X, seed=7)
        assert out.shape == (L, n, T, 1, 28, 28)
        np.testing.assert_allclose(out.numpy(), fn(X, 7).numpy(), **TOL)
        noise = serving.forecast_noise(
            tgp, tm, n, L, torch.Generator().manual_seed(7))
        assert torch.equal(fn(X, 0, noise=noise), fn(X, 7))
    assert not torch.equal(fc(raw(11, 1), 7), fc(raw(11, 1), 8))
    assert ops.LAUNCHES == before      # the CPU takes the plain versions


# -- the file and its manifest ------------------------------------------------

def test_manifest_written_and_carried(tiny, tmp_path):
    _, _, _, _, _, fc = tiny
    path = str(tmp_path / 'fc.pt2')
    nbytes = serving.save_forecaster(fc, path)
    assert nbytes == os.path.getsize(path)
    with open(path + '.manifest.json') as f:
        m = json.load(f)
    assert m['format'] == serving.FORMAT and m['manifest_version'] == 1
    assert m['torch_version'] == torch.__version__
    assert m['op_namespace'] == library.NAMESPACE == 'vae_gp_ode_torch'
    assert m['platforms'] == ['cpu'] and m['dtype'] == 'f32'
    assert m['max_batch'] is None      # unbounded on the CPU
    assert m['nbytes'] == nbytes
    assert m['in_specs'][0]['shape'] == ['b', str(T), '1', '28', '28']
    assert [s[0] for s in m['noise_spec']] == [
        'z0', 'omega', 'phase_u', 'weights', 'epsilon']
    assert m['in_specs'][1]['shape'] == ['b', str(Q)]
    assert m['out_specs'][0]['shape'] == [str(L), 'b', str(T), '1', '28',
                                          '28']
    loaded = serving.load_forecaster(path, device='cpu')
    assert loaded.manifest == m
    X = raw(5)
    assert torch.equal(loaded(X, seed=3), fc(X, seed=3))


def test_platform_mismatch_is_actionable(tiny, tmp_path):
    """An artifact for the card only, loaded on the CPU, raises naming
    both devices and --platforms; check_platform=False loads it."""
    _, _, _, tm, tgp, _ = tiny
    fc = serving.export_forecaster(tm, None, tgp, T=T, batch=N, L=1,
                                   platforms=('cuda',), device='cpu')
    path = str(tmp_path / 'fc_cuda.pt2')
    serving.save_forecaster(fc, path)
    with pytest.raises(RuntimeError) as ei:
        serving.load_forecaster(path, device='cpu')
    msg = str(ei.value)
    assert 'cuda' in msg and 'cpu' in msg and '--platforms' in msg
    fc2 = serving.load_forecaster(path, device='cpu', check_platform=False)
    assert fc2.platforms == ('cuda',)
    with pytest.raises(ValueError, match='platforms'):
        serving.export_forecaster(tm, None, tgp, T=T, platforms=('tpu',),
                                  device='cpu')


def test_corrupt_artifact_error_carries_provenance(tiny, tmp_path):
    _, _, _, _, _, fc = tiny
    path = str(tmp_path / 'fc.pt2')
    serving.save_forecaster(fc, path)
    with open(path, 'wb') as f:
        f.write(b'not a torch.export artifact')
    with pytest.raises(RuntimeError) as ei:
        serving.load_forecaster(path, device='cpu')
    msg = str(ei.value)
    assert 'failed to deserialize' in msg
    assert f'exported with torch {torch.__version__}' in msg


def test_load_without_manifest_and_without_gpu(tiny, tmp_path,
                                               monkeypatch):
    """A file without its manifest loads as before; the default device
    is the card, which raises where there is none."""
    _, _, _, _, _, fc = tiny
    path = str(tmp_path / 'fc.pt2')
    serving.save_forecaster(fc, path)
    os.remove(path + '.manifest.json')
    loaded = serving.load_forecaster(path, device='cpu')
    assert loaded.manifest is None
    assert loaded(raw(6, 2), seed=3).shape == (L, 2, T, 1, 28, 28)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        serving.load_forecaster(path)


# -- run directories, a fresh process, the CLI and the HTTP server ------------

def _write_jax_run_dir(tmp_path, model, variables, gp):
    """A run directory as the JAX `main.py` leaves one (args.json + npz
    checkpoint)."""
    state, _ = jcreate_train_state(model, variables, gp)
    run = tmp_path / 'run'
    run.mkdir()
    jckpt.save_checkpoint(state, str(run / 'odegpvae_mnist.ckpt'))
    args = dict(latent_dim=Q, n_filt=NF, ode=1, frames=5, dt=0.1,
                solver='euler', ts_dense_scale=1, num_features=S,
                num_inducing=M, kernel='RBF', q_diag=False, dimwise=True,
                D_in=Q, D_out=Q, T=T, seed=0, pretrained=False, lr=1e-3)
    (run / 'args.json').write_text(json.dumps(args))
    return run


@pytest.fixture(scope='module')
def run_dir(tiny, tmp_path_factory):
    jm, jv, jgp, _, _, _ = tiny
    return _write_jax_run_dir(tmp_path_factory.mktemp('serving'), jm, jv,
                              jgp)


def test_export_run_dir(tiny, run_dir, tmp_path):
    """A run directory in the JAX package's format and the shipped DF
    checkpoint export to artifacts: the run's frames are those of the
    port's eager forecaster of the same weights (which
    `test_artifact_matches_jax` holds to JAX's) at the same noise, the
    checkpoint's a finite rollout through the DF trajectory operator."""
    _, _, _, tm, tgp, _ = tiny
    out = str(tmp_path / 'run.pt2')
    fc, nbytes = serving.export_run_dir(str(run_dir), out, L=1, batch=N,
                                        device='cpu')
    assert nbytes == os.path.getsize(out)
    X = (raw(9) - serving.MNIST_MEAN) / serving.MNIST_STD
    loaded = serving.load_forecaster(out, device='cpu')
    noise = serving.forecast_noise(tgp, tm, N, 1,
                                   torch.Generator().manual_seed(4))
    eager = serving.make_forecast_fn(tm, None, tgp, L=1, device='cpu')
    np.testing.assert_allclose(loaded.call(X, noise).numpy(),
                               eager(X, 0, noise=noise).numpy(), **TOL)

    ck = os.path.join(ROOT, 'checkpoints', 'df_5000ep')
    dfc, _ = serving.export_run_dir(ck, str(tmp_path / 'df.pt2'), L=1,
                                    Troll=2, device='cpu')
    assert dfc.input_shape == ('b', 16, 1, 28, 28)
    y = dfc(raw(10, 2, 16), seed=2)
    assert y.shape == (1, 2, 32, 1, 28, 28) and bool(torch.isfinite(y).all())
    assert 'vae_gp_ode_torch.df_flow_fused_fwd.default' in {
        str(n.target) for n in dfc.program.graph.nodes}


def test_cli_fresh_process_and_http(run_dir, tmp_path, capsys):
    """The CLI (`serving._main`) exports a run directory (symbolic batch,
    a 2T rollout, the MC mean) and prints its JSON line. A fresh process
    loads and calls the artifact with neither jax nor the port's model
    code imported, then serves it over HTTP (`serve_http.main`, port 0):
    /health and /predict with the artifact's frames, and 400 for a shape
    the artifact does not take."""
    art = str(tmp_path / 'cli.pt2')
    serving._main(['--device', 'cpu', '--model_path', str(run_dir),
                   '--out', art, '--L', '1', '--Troll', '2', '--mc_reduce',
                   'mean'])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info['bytes'] == os.path.getsize(art)
    assert info['input_shape'] == ['b', str(T), '1', '28', '28']
    assert info['platforms'] == ['cpu']

    env = dict(os.environ, PYTHONPATH=ROOT)
    prog = (
        'import sys\n'
        'import numpy as np\n'
        'from vae_gp_ode_tpu_torch import serve_http, serving\n'
        f'fc = serving.load_forecaster({art!r}, device="cpu")\n'
        f'x = np.random.default_rng(0).random((5, {T}, 1, 28, 28))\n'
        'y = fc(x.astype("float32"), seed=1)\n'
        f'assert tuple(y.shape) == (5, {2 * T}, 1, 28, 28)\n'
        'assert bool(y.isfinite().all())\n'
        'bad = [m for m in sys.modules if m.split(".")[0] == "jax"\n'
        '       or m.startswith("vae_gp_ode_tpu_torch.models")]\n'
        'assert not bad, bad\n'
        f'serve_http.main(["--artifact", {art!r}, "--port", "0",\n'
        '                 "--device", "cpu"])\n')
    proc = subprocess.Popen([sys.executable, '-c', prog], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stdout.readline()
        assert line, proc.stderr.read()[-2000:]
        port = json.loads(line)['port']
        base = f'http://127.0.0.1:{port}'
        with urllib.request.urlopen(base + '/health', timeout=60) as resp:
            health = json.loads(resp.read())
        assert health['ok'] and health['input_shape'][0] == 'b'
        assert health['device'] == 'cpu'
        x = raw(12, 2)
        req = json.dumps({'x': x.tolist(), 'seed': 3}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                base + '/predict', data=req,
                headers={'Content-Type': 'application/json'}),
                timeout=120) as resp:
            out = json.loads(resp.read())
        assert out['shape'] == [2, 2 * T, 1, 28, 28]
        local = serving.load_forecaster(art, device='cpu')
        np.testing.assert_allclose(np.asarray(out['y'], np.float32),
                                   local(x, seed=3).numpy(), **TOL)
        bad = json.dumps({'x': raw(1, 1, T + 1).tolist()}).encode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                base + '/predict', data=bad), timeout=60)
        assert ei.value.code == 400
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_card_refuses_a_cpu_trace_the_fused_pair_refuses(tiny, tmp_path,
                                                         monkeypatch):
    """A program traced on the CPU takes the fused euler pair at every
    shape; on the card `load_forecaster` checks each trajectory's shapes
    against the pair's rule (`fused_pair_fits`, stubbed here as the card
    would answer for a shape it refuses) and raises naming them."""
    from vae_gp_ode_tpu_torch.ops import flow_fused
    _, _, _, _, _, fc = tiny
    path = str(tmp_path / 'fc.pt2')
    serving.save_forecaster(fc, path)
    program = serving.load_forecaster(path, device='cpu').program
    asked = []
    monkeypatch.setattr(flow_fused, 'fused_pair_fits',
                        lambda *shape: asked.append(shape) or False)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda d: 'a card')
    with pytest.raises(RuntimeError, match=f'D={Q} S={S} M={M} T={T}'):
        serving._fused_shapes_fit(program, torch.device('cpu'))
    assert asked == [(Q, Q, S, M, T, torch.device('cpu'))]
    monkeypatch.setattr(flow_fused, 'fused_pair_fits', lambda *shape: True)
    serving._fused_shapes_fit(program, torch.device('cpu'))
