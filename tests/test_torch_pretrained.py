"""Parity of the port's pretrained-VAE workflow with the JAX package, on the
CPU at small sizes: the pretraining data (`data.synthetic`
`make_rotating_frames`, `data.mnist`'s frame loaders and `normalize=`),
the VAE weight files (`training.checkpoint` `save_vae_weights`/
`load_vae_weights`, the reference's `encoder.pt`/`decoder.pt` and
`odegpvae_mnist.pth` through `utils.torch_import`), the frozen-VAE train
state and step (`freeze_vae`), frozen checkpoints in both formats, and
`main_vae`'s pretraining step.

Tolerances: arrays and batch order equal; rotations (scipy here, the JAX
package's native C++ where it builds) 1e-5; the VAE's eval outputs from
imported weights 1e-5; losses 1e-4 relative (frozen train steps: f32
through the decoder, the GP draw and the euler steps, summed in other
orders) and 1e-5 relative (the pretraining ELBO); GP leaves after two
frozen steps and VAE parameters after two pretraining steps 1e-5 of
each leaf's largest entry (not the convolution biases before a
BatchNorm, whose exact gradient is 0: see that test); the frozen VAE
weights and the encoder's and
decoder's BatchNorm statistics bit for bit; the order-2 velocity
encoder's statistics 1e-5 of each buffer's largest entry.
"""

import functools
import os
import pickle
import types

import numpy as np
import pytest
import scipy.io
import torch

import jax
import jax.numpy as jnp
import optax

from vae_gp_ode_tpu.data import mnist as jmnist
from vae_gp_ode_tpu.data import synthetic as jsynthetic
from vae_gp_ode_tpu.gp.svgp import init_svgp_params as jinit_svgp_params
from vae_gp_ode_tpu.models.odegpvae import ODEGPVAE as JODEGPVAE
from vae_gp_ode_tpu.models.vae import Decoder as JDecoder
from vae_gp_ode_tpu.models.vae import Encoder as JEncoder
from vae_gp_ode_tpu.models.vae import (
    bernoulli_log_prob as jbernoulli, gaussian_kl_standard as jkl,
    reparam_sample as jreparam)
from vae_gp_ode_tpu.training import checkpoint as jcheckpoint
from vae_gp_ode_tpu.training import trainer as jtrainer
from vae_gp_ode_tpu.utils import torch_import as jti

from vae_gp_ode_tpu_torch import main as tmain
from vae_gp_ode_tpu_torch import main_vae
from vae_gp_ode_tpu_torch.data import mnist, synthetic
from vae_gp_ode_tpu_torch.models.odegpvae import init_model
from vae_gp_ode_tpu_torch.models.vae import Decoder, Encoder
from vae_gp_ode_tpu_torch.training import checkpoint, trainer
from vae_gp_ode_tpu_torch.utils import torch_import
from vae_gp_ode_tpu_torch.utils.jax_import import (
    decoder_from_jax, encoder_from_jax, train_state_from_jax)

from test_torch_import import (
    _randomize_bn_stats, make_torch_decoder, make_torch_encoder)
from test_torch_train import (
    L, M, NDATA, NF, Q, S, _X, _bn_named, _gp_np, _jax_noise,
    _jax_state, _named)
import torch_threads  # noqa: F401

ROT = 1e-5          # scipy's rotation against the JAX package's native one
OUT = 1e-5          # eval outputs from imported weights


# -- the pretraining data ----------------------------------------------------

def test_make_rotating_frames_and_dataset_match_jax():
    """The frames of both packages (same glyph stream, same angles), and
    create_rotating_dataset's two seeds; a digit other than 3 warns."""
    got = synthetic.make_rotating_frames(3, n_angles=5, seed=1)
    want = jsynthetic.make_rotating_frames(3, n_angles=5, seed=1)
    assert got.shape == want.shape == (3, 5, 1, 28, 28)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 0], want[:, 0])     # unrotated
    np.testing.assert_allclose(got, want, rtol=0, atol=ROT)
    train, test = mnist.create_rotating_dataset(
        digit=3, train_n=2, test_n=1, n_angles=4, seed=2)
    jtrain, jtest = jmnist.create_rotating_dataset(
        digit=3, train_n=2, test_n=1, n_angles=4, seed=2)
    np.testing.assert_allclose(train, jtrain, rtol=0, atol=ROT)
    np.testing.assert_allclose(test, jtest, rtol=0, atol=ROT)
    with pytest.warns(UserWarning, match='digit=7'):
        mnist.create_rotating_dataset(digit=7, train_n=1, test_n=1,
                                      n_angles=2)


def _epochs(loader, n=2):
    """n epochs of a loader's batches as numpy (items, labels)."""
    out = []
    for _ in range(n):
        for b in loader:
            x, y = b if isinstance(b, tuple) else (b, None)
            out.append((np.asarray(x), None if y is None else np.asarray(y)))
    return out


def _same_batches(got, want, atol=0.0):
    assert len(got) == len(want)
    for (x, y), (jx, jy) in zip(got, want):
        np.testing.assert_allclose(x, jx, rtol=0, atol=atol)
        if jy is None:
            assert y is None
        else:
            np.testing.assert_array_equal(y, jy)


def test_load_rotating_mnist_data_matches_jax(tmp_path):
    """(frames, labels) batches of a saved .npy, over two epochs, and the
    stacked epoch with its ragged tail: the same items in the same order."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / 'frames.npy')
    np.save(path, rng.random((5, 4, 1, 28, 28)).astype(np.float32))
    got = mnist.load_rotating_mnist_data(path, 4, 6, seed=7, device='cpu')
    want = jmnist.load_rotating_mnist_data(path, 4, 6, seed=7)
    assert len(got) == len(want) == 4
    _same_batches(_epochs(got), _epochs(want))
    stacked, tail = got.epoch_batches_with_tail()
    jstacked, jtail = want.epoch_batches_with_tail()
    np.testing.assert_array_equal(stacked.numpy(), np.asarray(jstacked))
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
    x, labels = got.first()
    assert x.shape == (6, 1, 28, 28) and labels.dtype == torch.uint8


def test_load_mnist_data_unnormalised_matches_jax(tmp_path):
    """normalize=False keeps [0, 1] pixels; the splits and their batch
    order are the JAX package's (synthetic sequences, rotations 1e-5)."""
    kw = dict(data_root=str(tmp_path), batch_size=3, T=4, Ndata=4,
              Nvalid=2, Ntest=2, seed=4)
    got = mnist.load_mnist_data(normalize=False, device='cpu', **kw)
    want = jmnist.load_mnist_data(normalize=False, **kw)
    normed = mnist.load_mnist_data(device='cpu', **kw)
    for g, w, n in zip(got, want, normed):
        assert g.X.shape == tuple(w.X.shape)
        assert float(g.X.min()) >= 0.0 and float(g.X.max()) <= 1.0
        np.testing.assert_allclose(
            n.X.numpy(), (g.X.numpy() - mnist.MNIST_MEAN) / mnist.MNIST_STD,
            rtol=1e-6, atol=1e-6)
        _same_batches(_epochs(g), _epochs(w), atol=ROT)


def test_load_mat_mnist_data_matches_jax(tmp_path):
    """Unnormalised frames of the .mat sequences of one digit, labelled
    with their frame index, in the JAX package's batches."""
    rng = np.random.default_rng(5)
    os.makedirs(tmp_path / 'rot_mnist')
    X = rng.random((7, 4, 784)).astype(np.float32)
    Y = np.array([3, 1, 3, 3, 2, 3, 3])
    scipy.io.savemat(str(tmp_path / 'rot_mnist' / 'rot-mnist.mat'),
                     {'X': X, 'Y': Y})
    args = types.SimpleNamespace(data_root=str(tmp_path), value=3,
                                 mask=True, Ndata=3, Ntest=2, T=4, batch=5,
                                 seed=6)
    got = mnist.load_mat_mnist_data(args, device='cpu')
    want = jmnist.load_mat_mnist_data(args)
    for g, w in zip(got, want):
        _same_batches(_epochs(g), _epochs(w))
    train = got[0]
    np.testing.assert_array_equal(
        train.X.numpy(), X[Y == 3][:3].reshape(12, 1, 28, 28))
    np.testing.assert_array_equal(train.labels.numpy(),
                                  np.tile(np.arange(4), 3))


# -- VAE weight files --------------------------------------------------------

def _jax_vae(seed, q=6, nf=8):
    """A flax encoder and decoder with lecun weights, random BatchNorm
    scales, biases and running statistics."""
    enc, dec = JEncoder(latent_dim=q, n_filt=nf), JDecoder(latent_dim=q,
                                                         n_filt=nf)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    ev = jax.jit(functools.partial(enc.init, train=True))(
        k1, jnp.zeros((2, 28, 28, 1)))
    dv = jax.jit(functools.partial(dec.init, train=True))(
        k2, jnp.zeros((2, q)))
    rng = np.random.default_rng(seed)

    def shake(tree, kind):
        def one(path, x):
            name = path[-1].key
            x = np.asarray(x)
            if name == 'scale' or name == 'var':
                return (rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
            if kind == 's' or name == 'bias':
                return (0.1 * rng.standard_normal(x.shape)).astype(
                    np.float32)
            return x
        return jax.tree_util.tree_map_with_path(one, tree)

    return (enc, {'params': shake(ev['params'], 'p'),
                  'batch_stats': shake(ev['batch_stats'], 's')},
            dec, {'params': shake(dv['params'], 'p'),
                  'batch_stats': shake(dv['batch_stats'], 's')})


def _port_vae_outputs(encoder, decoder, x, z):
    encoder.eval(), decoder.eval()
    with torch.no_grad():
        mu, logv = encoder(torch.as_tensor(x))
        y = decoder(torch.as_tensor(z))
    return mu.numpy(), logv.numpy(), y.numpy()


def test_jax_vae_files_load_into_the_port(tmp_path):
    """The JAX package's npz encoder.ckpt/decoder.ckpt (flax layout) read
    by load_vae_weights: eval-mode outputs of the port's modules equal the
    JAX modules'; the port's own files round-trip bit for bit."""
    enc, ev, dec, dv = _jax_vae(0)
    paths = (str(tmp_path / 'encoder.ckpt'), str(tmp_path / 'decoder.ckpt'))
    jcheckpoint.save_vae_weights(
        {'encoder': ev['params'], 'decoder': dv['params']},
        {'encoder': ev['batch_stats'], 'decoder': dv['batch_stats']},
        *paths)
    assert checkpoint.checkpoint_format(paths[0]) == 'npz'
    enc_sd, dec_sd = checkpoint.load_vae_weights(*paths)
    encoder, decoder = Encoder(6, 8), Decoder(6, 8)
    checkpoint.load_state_checked(encoder, enc_sd, 'encoder')
    checkpoint.load_state_checked(decoder, dec_sd, 'decoder')
    rng = np.random.default_rng(1)
    x = rng.random((4, 1, 28, 28)).astype(np.float32)
    z = rng.standard_normal((5, 6)).astype(np.float32)
    mu, logv, y = _port_vae_outputs(encoder, decoder, x, z)
    jmu, jlogv = jax.jit(functools.partial(enc.apply, train=False))(
        ev, jnp.asarray(x.transpose(0, 2, 3, 1)))
    jy = jax.jit(functools.partial(dec.apply, train=False))(
        dv, jnp.asarray(z))
    np.testing.assert_allclose(mu, np.asarray(jmu), rtol=0, atol=OUT)
    np.testing.assert_allclose(logv, np.asarray(jlogv), rtol=0, atol=OUT)
    np.testing.assert_allclose(y, np.asarray(jy).transpose(0, 3, 1, 2),
                               rtol=0, atol=OUT)

    mine = (str(tmp_path / 'enc.ckpt'), str(tmp_path / 'dec.ckpt'))
    checkpoint.save_vae_weights(encoder, decoder, *mine)
    assert checkpoint.checkpoint_format(mine[0]) == 'torch'
    for sd, module in zip(checkpoint.load_vae_weights(*mine),
                          (encoder, decoder)):
        own = module.state_dict()
        assert list(sd) == list(own)
        for k, v in own.items():
            assert torch.equal(sd[k], v), k


def test_vae_files_refuse_pickles_and_other_shapes(tmp_path):
    """A legacy pickle VAE file is refused before anything is read; a file
    of another width names the tensor that differs."""
    legacy = tmp_path / 'encoder.ckpt'
    with open(legacy, 'wb') as f:
        pickle.dump({'params': {}}, f)
    with pytest.raises(ValueError, match='pickle'):
        checkpoint.load_vae_weights(str(legacy), str(legacy))
    with pytest.raises(FileNotFoundError):
        checkpoint.checkpoint_format(str(tmp_path / 'missing.ckpt'))
    paths = (str(tmp_path / 'e.ckpt'), str(tmp_path / 'd.ckpt'))
    checkpoint.save_vae_weights(Encoder(6, 8), Decoder(6, 8), *paths)
    enc_sd, _ = checkpoint.load_vae_weights(*paths)
    with pytest.raises(ValueError, match='fc.weight has shape'):
        checkpoint.load_state_checked(Encoder(3, 8), enc_sd, 'encoder')


def test_reference_pt_files_load_as_the_jax_package_reads_them(tmp_path):
    """The reference's encoder.pt/decoder.pt (state dicts of its own
    topology, torch.save) through main's --pretrained loader: the port's
    eval outputs equal JAX utils/torch_import's conversion's."""
    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    enc_t, dec_t = make_torch_encoder(), make_torch_decoder()
    with torch.no_grad():
        _randomize_bn_stats(enc_t, rng)
        _randomize_bn_stats(dec_t, rng)
    torch.save(enc_t.state_dict(), tmp_path / 'encoder.pt')
    torch.save(dec_t.state_dict(), tmp_path / 'decoder.pt')
    model, _ = init_model(0, device='cpu')
    tmain.load_pretrained_vae(model, str(tmp_path))
    x = rng.rand(4, 1, 28, 28).astype(np.float32)
    z = rng.randn(5, 6).astype(np.float32)
    mu, logv, y = _port_vae_outputs(model.encoder, model.decoder, x, z)
    ep, es = jti.encoder_from_torch(enc_t.state_dict())
    dp, ds = jti.decoder_from_torch(dec_t.state_dict())
    jmu, jlogv = JEncoder(6, 8).apply(
        {'params': ep, 'batch_stats': es},
        jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    jy = JDecoder(6, 8).apply({'params': dp, 'batch_stats': ds},
                              jnp.asarray(z), train=False)
    np.testing.assert_allclose(mu, np.asarray(jmu), rtol=0, atol=OUT)
    np.testing.assert_allclose(logv, np.asarray(jlogv), rtol=0, atol=OUT)
    np.testing.assert_allclose(y, np.asarray(jy).transpose(0, 3, 1, 2),
                               rtol=0, atol=OUT)


def test_full_reference_pth_matches_jax_import():
    """A reference odegpvae_mnist.pth state dict (VAE under vae.*, GP
    under flow.odefunc.diffeq.*) into the port and, by JAX
    utils/torch_import, into the JAX model: the GP leaves equal and the
    eval-mode forward with the same draws within 1e-5."""
    torch.manual_seed(3)
    rng = np.random.RandomState(3)
    enc_t, dec_t = make_torch_encoder(q=Q, nf=NF), make_torch_decoder(
        q=Q, nf=NF)
    with torch.no_grad():
        _randomize_bn_stats(enc_t, rng)
        _randomize_bn_stats(dec_t, rng)
    sd = {f'vae.encoder.{k}': v for k, v in enc_t.state_dict().items()}
    sd.update({f'vae.decoder.{k}': v for k, v in dec_t.state_dict().items()})
    p = 'flow.odefunc.diffeq.'
    sd.update({
        p + 'kern.unconstrained_lengthscales':
            rng.uniform(0.0, 1.0, (Q, Q)).astype(np.float32),
        p + 'kern.unconstrained_variance':
            rng.uniform(-1.0, 0.0, Q).astype(np.float32),
        p + 'inducing_loc.optvar': rng.randn(M, Q).astype(np.float32),
        p + 'Um.optvar': (0.3 * rng.randn(M, Q)).astype(np.float32),
        p + 'Us_sqrt.optvar':
            (0.05 * rng.randn(Q, M * (M + 1) // 2)).astype(np.float32),
        'unrelated.key': np.zeros(2, np.float32)})

    # templates without flax's init (which runs the whole forward): an
    # order-1 model's variables are the encoder's and decoder's alone
    jmodel = JODEGPVAE(latent_dim=Q, n_filt=NF, num_features=S)
    jvars, jgp = jti.odegpvae_from_torch(
        sd, {'params': {}, 'batch_stats': {}},
        jinit_svgp_params(jax.random.PRNGKey(0), Q, Q, M), n_filt=NF)
    model, gp = init_model(1, latent_dim=Q, n_filt=NF, num_features=S,
                           num_inducing=M, device='cpu')
    model, gp = torch_import.odegpvae_from_torch(sd, model, gp)
    for (name, leaf), want in zip(gp.named_parameters(),
                                  jax.tree_util.tree_leaves(jgp)):
        np.testing.assert_array_equal(leaf.detach().numpy(),
                                      np.asarray(want), err_msg=name)
    X = _X(11)
    key = jax.random.PRNGKey(12)
    jXrec = jax.jit(lambda v, x, g, k: jmodel.apply(
        v, x, g, k, L=L, train=False)[0])(jvars, jnp.asarray(X), jgp, key)
    with torch.no_grad():
        Xrec = model.eval()(torch.as_tensor(X), gp, L=L,
                            noise=_jax_noise(key, 1))[0]
    np.testing.assert_allclose(Xrec.numpy(), np.asarray(jXrec), rtol=0,
                               atol=OUT)
    bad = dict(sd)
    bad[p + 'Um.optvar'] = bad[p + 'Um.optvar'][:-1]
    with pytest.raises(ValueError, match='Um.optvar has shape'):
        torch_import.odegpvae_from_torch(bad, model, gp)


# -- the frozen VAE: train state, step, checkpoints --------------------------

def _frozen_jax_state(order, seed):
    """A frozen-VAE JAX TrainState (multi_transform: Adam over the GP
    alone) from _jax_state's weights, statistics and GP."""
    model, js, _ = _jax_state(order, seed=seed)
    state, tx = jtrainer.create_train_state(
        model, {'params': js.vae_params, 'batch_stats': js.batch_stats},
        js.gp, lr=1e-3, freeze_vae=True)
    return model, state, tx


def _frozen_np_state(state):
    """A frozen JAX TrainState as train_state_from_jax's numpy dicts (Adam
    holds the GP leaves alone)."""
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(
            x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    tree = lambda t: jax.tree.map(np.asarray, t)           # noqa: E731
    return {'step': int(state.step),
            'variables': {'params': tree(state.vae_params),
                          'batch_stats': tree(state.batch_stats)},
            'gp': _gp_np(state.gp),
            'adam': {'count': int(adam.count),
                     'mu': {'gp': _gp_np(adam.mu[1])},
                     'nu': {'gp': _gp_np(adam.nu[1])}}}


def _vae_snapshot(model):
    return {n: t.detach().clone() for n, t in
            list(model.named_parameters()) + list(model.named_buffers())}


@pytest.mark.parametrize('order', [1, 2])
def test_two_frozen_steps_follow_the_jax_steps(order):
    """Two frozen-VAE train steps (L=2) of the port and of JAX
    make_train_step(freeze_vae=True) from one state with the same noise:
    the metrics, the GP leaves after them, the VAE weights and the
    encoder's and decoder's statistics unchanged bit for bit, and (order
    2) the velocity encoder's train-mode statistics as JAX moves them.
    Adam holds the GP leaves alone and no VAE gradient is computed."""
    model, jstate, tx = _frozen_jax_state(order, seed=20 + order)
    tstate = train_state_from_jax(
        _frozen_np_state(jstate), latent_dim=Q, n_filt=NF, order=order,
        num_features=S, freeze_vae=True, device='cpu')
    assert tstate.param_names() == [f'gp.{n}' for n in tstate.gp.LEAVES]
    assert tstate.optimizer.mu.numel() == sum(
        p.numel() for p in tstate.gp.parameters())
    before = _vae_snapshot(tstate.model)
    jstep = jtrainer.make_train_step(model, tx, NDATA, eps_guard=True,
                                     freeze_vae=True)
    step = trainer.make_train_step(NDATA, eps_guard=True)
    for i, key in enumerate((jax.random.PRNGKey(30), jax.random.PRNGKey(31))):
        X = _X(40 + i)
        jstate, jm = jstep(jstate, jnp.asarray(X), key, L)
        tm = step(tstate, torch.as_tensor(X), L, noise=_jax_noise(key, order))
        for k in ('loss', 'nll', 'kl_reg', 'kl_u'):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
    assert int(tstate.step) == int(jstate.step) == 2
    want = _named(jstate.vae_params, jstate.gp)
    for name, p in zip(tstate.param_names(), tstate.params()):
        err = np.abs(p.detach().numpy() - want[name]).max()
        assert err <= 1e-5 * np.abs(want[name]).max(), (name, err)
    after = _vae_snapshot(tstate.model)
    for name, t in before.items():
        if name.startswith('encoder_v.') and 'running' in name:
            continue
        assert torch.equal(t, after[name]), name
    assert all(p.grad is None and not p.requires_grad
               for p in tstate.model.parameters())
    if order == 2:
        want_bn = _bn_named(jstate.batch_stats, jstate.vae_params)
        moved = 0
        for name, t in after.items():
            if name.startswith('encoder_v.') and 'running' in name:
                err = np.abs(t.numpy() - want_bn[name]).max()
                assert err <= 1e-5 * np.abs(want_bn[name]).max(), name
                moved += not torch.equal(t, before[name])
        assert moved == 4


def test_frozen_nan_guard_restores_the_velocity_encoder():
    """A non-finite loss in a frozen order-2 step leaves everything as it
    was, the velocity encoder's train-mode statistics included (NaN in
    frame 1 reaches only the velocity encoder)."""
    _, jstate, _ = _frozen_jax_state(2, seed=24)
    tstate = train_state_from_jax(
        _frozen_np_state(jstate), latent_dim=Q, n_filt=NF, order=2,
        num_features=S, freeze_vae=True, device='cpu')
    step = trainer.make_train_step(NDATA, eps_guard=True)
    gen = torch.Generator().manual_seed(0)
    step(tstate, torch.as_tensor(_X(25)), L, gen)
    before = _vae_snapshot(tstate.model)
    before.update({f'gp.{n}': p.detach().clone()
                   for n, p in tstate.gp.named_parameters()})
    mu = tstate.optimizer.mu.clone()
    bad = torch.as_tensor(_X(26))
    bad[0, 1, 0, 0, 0] = float('nan')
    assert not torch.isfinite(step(tstate, bad, L, gen)['loss'])
    after = _vae_snapshot(tstate.model)
    after.update({f'gp.{n}': p for n, p in tstate.gp.named_parameters()})
    for name, t in before.items():
        assert torch.equal(t, after[name]), name
    assert torch.equal(mu, tstate.optimizer.mu) and int(tstate.step) == 1


def test_frozen_jax_checkpoint_restores_into_the_port(tmp_path):
    """A frozen-VAE JAX TrainState after one step, written by JAX
    save_checkpoint (Adam's count, mu and nu of the GP alone, MaskedNode
    where the VAE would be), read by restore_jax_checkpoint: every leaf,
    statistic and moment; not into a state that is not frozen, nor a
    non-frozen JAX checkpoint into a frozen state."""
    model, jstate, tx = _frozen_jax_state(2, seed=27)
    jstep = jtrainer.make_train_step(model, tx, NDATA, eps_guard=True,
                                     freeze_vae=True)
    jstate, _ = jstep(jstate, jnp.asarray(_X(28)), jax.random.PRNGKey(3), L)
    path = str(tmp_path / 'frozen.ckpt')
    jcheckpoint.save_checkpoint(jstate, path)
    carried = train_state_from_jax(
        _frozen_np_state(jstate), latent_dim=Q, n_filt=NF, order=2,
        num_features=S, freeze_vae=True, device='cpu')

    def fresh(freeze):
        m, g = init_model(9, latent_dim=Q, n_filt=NF, order=2,
                          num_features=S, num_inducing=M, device='cpu')
        return trainer.create_train_state(m, g, freeze_vae=freeze)

    state = checkpoint.restore_jax_checkpoint(path, fresh(True))
    assert int(state.step) == int(carried.step) == 1
    assert int(state.optimizer.count) == int(carried.optimizer.count) == 1
    for a, b in zip(state.params(), carried.params()):
        assert torch.equal(a, b)
    for (n, a), b in zip(state.model.state_dict().items(),
                         carried.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert torch.equal(state.optimizer.mu, carried.optimizer.mu)
    assert torch.equal(state.optimizer.nu, carried.optimizer.nu)
    assert state.optimizer.mu.abs().max() > 0
    with pytest.raises(ValueError, match='leaves'):
        checkpoint.restore_jax_checkpoint(path, fresh(False))
    _, full, _ = _jax_state(2, seed=27)
    jcheckpoint.save_checkpoint(full, str(tmp_path / 'full.ckpt'))
    with pytest.raises(ValueError, match='frozen-VAE'):
        checkpoint.restore_jax_checkpoint(str(tmp_path / 'full.ckpt'),
                                          fresh(True))


def test_frozen_checkpoint_round_trip(tmp_path):
    """save_checkpoint/restore_checkpoint of a frozen state (Adam over the
    GP leaves alone) after one step; a frozen checkpoint does not restore
    into a state that is not frozen."""
    _, jstate, _ = _frozen_jax_state(1, seed=29)
    tstate = train_state_from_jax(
        _frozen_np_state(jstate), latent_dim=Q, n_filt=NF, num_features=S,
        freeze_vae=True, device='cpu')
    trainer.make_train_step(NDATA, True)(
        tstate, torch.as_tensor(_X(30)), L, torch.Generator().manual_seed(1))
    path = str(tmp_path / 'frozen.ckpt')
    checkpoint.save_checkpoint(tstate, path)
    m, g = init_model(2, latent_dim=Q, n_filt=NF, num_features=S,
                      num_inducing=M, device='cpu')
    back = checkpoint.restore_checkpoint(
        path, trainer.create_train_state(m, g, freeze_vae=True))
    assert torch.equal(back.optimizer.mu, tstate.optimizer.mu)
    assert torch.equal(back.optimizer.nu, tstate.optimizer.nu)
    for a, b in zip(back.params(), tstate.params()):
        assert torch.equal(a, b)
    assert int(back.step) == 1
    m, g = init_model(2, latent_dim=Q, n_filt=NF, num_features=S,
                      num_inducing=M, device='cpu')
    with pytest.raises(ValueError, match='mismatch'):
        checkpoint.restore_checkpoint(path,
                                      trainer.create_train_state(m, g))


# -- main_vae's pretraining step ---------------------------------------------

def test_pretraining_steps_match_the_jax_step():
    """Two of main_vae's ELBO steps against the step of the JAX
    main_vae.py (flax Encoder/Decoder, train-mode BatchNorm, optax.adam)
    from the same weights and the same reparameterisation draws: the
    loss terms 1e-5 relative, then every parameter and running statistic
    1e-5 of its largest entry. Not the convolution biases that feed a
    BatchNorm: their exact gradient is 0 and rounding picks the sign of
    Adam's ~lr step in each package (held to two such steps), and the
    running mean of the BatchNorm each feeds moves by momentum (0.1) x
    their gap after the first step (allowed on top)."""
    q, nf = 4, 4
    enc, ev, dec, dv = _jax_vae(13, q=q, nf=nf)
    params = (ev['params'], dv['params'])
    bstats = (ev['batch_stats'], dv['batch_stats'])
    tx = optax.adam(1e-3)
    opt = tx.init(params)

    @jax.jit
    def jstep(params, bstats, opt, x_nchw, k):
        x = jnp.transpose(x_nchw, (0, 2, 3, 1))

        def loss_fn(ps):
            (mu, logv), eu = enc.apply({'params': ps[0],
                                        'batch_stats': bstats[0]}, x,
                                       train=True, mutable=['batch_stats'])
            z = jreparam(k, mu, logv)
            y, du = dec.apply({'params': ps[1], 'batch_stats': bstats[1]},
                              z, train=True, mutable=['batch_stats'])
            kl_reg = jnp.mean(jkl(mu, logv))
            lhood = jnp.mean(jnp.sum(jbernoulli(x, y, eps_guard=True),
                                     axis=(1, 2, 3)))
            return kl_reg - lhood, (lhood, kl_reg, eu['batch_stats'],
                                    du['batch_stats'])

        (loss, (lh, kr, ebs, dbs)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, upd), (ebs, dbs), opt, jnp.stack(
            [loss, lh, kr])

    vae = main_vae.make_vae(q, nf, device='cpu')
    for name, conv, p, s in (('encoder', encoder_from_jax, *ev.values()),
                             ('decoder', decoder_from_jax, *dv.values())):
        sd = conv(jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s),
                  'm')
        checkpoint.load_state_checked(
            getattr(vae, name), {k[2:]: v for k, v in sd.items()}, name)
    adam = trainer.Adam(vae.parameters(), lr=1e-3)
    step = main_vae.make_vae_step(adam, eps_guard=True)
    def jax_named():
        out = {}
        for name, conv, p, s in (('encoder', encoder_from_jax, params[0],
                                  bstats[0]),
                                 ('decoder', decoder_from_jax, params[1],
                                  bstats[1])):
            out.update({k: v.numpy() for k, v in conv(
                jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s),
                name).items()})
        return out

    # a bias before a BatchNorm has exact gradient 0 (the normalisation
    # removes it), so rounding picks the sign of Adam's ~lr step in each
    # package; the running mean of the BatchNorm it feeds moves with it
    biases = trainer.bias_before_batchnorm(vae)
    assert len(biases) == 5

    def fed(bias):      # 'encoder.cnn.0.bias' -> 'encoder.cnn.1.running_mean'
        *seq, i, _ = bias.split('.')
        return '.'.join(seq + [str(int(i) + 1), 'running_mean'])
    rng = np.random.default_rng(14)
    for i in range(2):
        x = rng.random((6, 1, 28, 28)).astype(np.float32)
        k = jax.random.PRNGKey(15 + i)
        eps = np.array(jax.random.normal(k, (6, q)))
        params, bstats, opt, jrow = jstep(params, bstats, opt,
                                          jnp.asarray(x), k)
        row = step(vae, torch.as_tensor(x), noise=torch.as_tensor(eps))
        np.testing.assert_allclose(row.numpy(), np.asarray(jrow), rtol=1e-5)
        if i == 0:
            first = jax_named()
            bias_gap = {b: np.abs(vae.state_dict()[b].numpy()
                                  - first[b]).max() for b in biases}
    want = jax_named()
    for name, t in vae.state_dict().items():
        if name.endswith('num_batches_tracked'):
            continue
        w = want[name]
        err = np.abs(t.numpy() - w).max()
        if name in biases:
            assert err <= 4 * 1e-3, (name, err)     # two steps of ~lr each
            continue
        lim = 1e-5 * np.abs(w).max()
        lim += sum(0.1 * gap for b, gap in bias_gap.items()
                   if fed(b) == name)               # momentum 0.1
        assert err <= lim, (name, err)


def test_main_vae_run_writes_what_pretrained_reads(tmp_path):
    """main_vae.run at a tiny size on the CPU: finite losses, every frame
    each epoch (a short last batch), the dataset saved for the next run,
    and MNIST-VAE/encoder.ckpt and decoder.ckpt that main's --pretrained
    loader reads into a model bit for bit."""
    args = main_vae.make_parser().parse_args([
        '--device', 'cpu', '--vae_epochs', '2', '--n_train', '3',
        '--n_test', '2', '--n_angle', '4', '--batch', '5', '--n_filt',
        str(NF), '--latent_dim', str(Q), '--log_freq', '1',
        '--output_path', str(tmp_path / 'vae'),
        '--save', str(tmp_path / 'frames')])
    result = main_vae.run(args)
    assert [e['rows'].shape for e in result['epochs']] == [(3, 3)] * 2
    assert all(np.isfinite(e['rows']).all() for e in result['epochs'])
    assert np.isfinite(result['test_mse'])
    assert sorted(os.listdir(tmp_path / 'frames')) == [
        'rotating_mnist_test_3_4_angles.npy',
        'rotating_mnist_train_3_4_angles.npy']
    assert sorted(os.listdir(result['model_dir'])) == ['decoder.ckpt',
                                                       'encoder.ckpt']
    model, _ = init_model(0, latent_dim=Q, n_filt=NF, device='cpu')
    tmain.load_pretrained_vae(model, result['model_dir'])
    vae = result['vae']
    for part in ('encoder', 'decoder'):
        for (n, a), b in zip(getattr(model, part).state_dict().items(),
                             getattr(vae, part).state_dict().values()):
            assert torch.equal(a, b), (part, n)
