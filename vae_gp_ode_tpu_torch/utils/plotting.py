"""Plotting utilities (port of `vae_gp_ode_tpu/utils/plotting.py`):
reconstruction grids, rollouts, latent-trajectory PCA, loss traces with
their .npy dumps, hyperparameter traces, VAE embedding PCA/t-SNE. Every
function takes host arrays (numpy, or CPU tensors) and has the JAX
module's name, arguments, files and return value.

matplotlib (Agg backend) is imported at the first draw, not with the
module: a host without it still writes every .npy dump and gets
`visualize_output`'s MSE; only the PNGs are left out, and `available()`
says so. The CLIs then log one line naming them.
"""

import os

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib does
    not import."""
    try:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def available():
    """Whether matplotlib imports, so that the PNGs are written."""
    return _pyplot() is not None


def _img(x):
    return np.asarray(x).reshape(28, 28)


def plot_rot_mnist(X, Xrec, show=False, fname='rot_mnist.png', N=None):
    """Ground-truth rows vs reconstruction rows, (N, T, ...) each."""
    plt = _pyplot()
    if plt is None:
        return
    X, Xrec = np.asarray(X), np.asarray(Xrec)
    N = min(X.shape[0], 10) if N is None else N
    T = X.shape[1]
    plt.figure(1, (T, 3 * N))
    for i in range(N):
        for t in range(T):
            plt.subplot(2 * N, T, i * T * 2 + t + 1)
            plt.imshow(_img(X[i, t]), cmap='gray')
            plt.xticks([]), plt.yticks([])
            plt.subplot(2 * N, T, i * T * 2 + t + T + 1)
            plt.imshow(_img(Xrec[i, t]), cmap='gray')
            plt.xticks([]), plt.yticks([])
    plt.savefig(fname)
    plt.close()


def plot_rollout(Xrec, fname='rollout.png'):
    """Long-horizon forecast grid. Xrec: (L, N, T, 1, d, d) or
    (N, T, 1, d, d)."""
    plt = _pyplot()
    if plt is None:
        return
    Xrec = np.asarray(Xrec)
    if Xrec.ndim == 6:
        Xrec = Xrec[0]
    N, T = Xrec.shape[:2]
    plt.figure(1, (T, N))
    for i in range(N):
        for t in range(T):
            plt.subplot(N, T, i * T + t + 1)
            plt.imshow(_img(Xrec[i, t]), cmap='gray')
            plt.xticks([]), plt.yticks([])
    plt.savefig(fname)
    plt.close()


def plot_rand_rot_mnist(X, Xrec, fname='rand_rot_mnist.png', rows=4):
    """Random-initial-angle variant over flat frames (B, 1, 28, 28):
    `rows` paired rows of N=4 columns, a ground-truth row above each
    reconstruction row, walking the flat index with the reference's
    skip-one-frame-per-row advance (columns and rows clamped to the
    frames there are)."""
    plt = _pyplot()
    if plt is None:
        return
    X = np.asarray(X)
    Xrec = np.asarray(Xrec)
    frames = min(X.shape[0], Xrec.shape[0])
    N = min(frames, 4)
    if N == 0:
        return
    rows = max(1, min(rows, (frames + 1) // (N + 1)))
    plt.figure(2, (N, 3 * rows))
    idx_x = idx_rec = 0
    for r in range(rows):
        for i in range(N):
            plt.subplot(2 * rows, N, r * N * 2 + i + 1)
            plt.imshow(_img(X[idx_x]), cmap='gray')
            plt.xticks([]), plt.yticks([])
            idx_x += 1
        for i in range(N):
            plt.subplot(2 * rows, N, r * N * 2 + i + N + 1)
            plt.imshow(_img(Xrec[idx_rec]), cmap='gray')
            plt.xticks([]), plt.yticks([])
            idx_rec += 1
        idx_x += 1
        idx_rec += 1
    plt.savefig(fname)
    plt.close()


def plot_data(X, fname='data.png', size=6):
    """The first `size` sequences (N, T, ...) as rows of frames."""
    plt = _pyplot()
    if plt is None:
        return
    X = np.asarray(X)
    N = min(X.shape[0], size)
    T = X.shape[1]
    plt.figure(1, (T, N))
    for i in range(N):
        for t in range(T):
            plt.subplot(N, T, i * T + t + 1)
            plt.imshow(_img(X[i, t]), cmap='gray')
            plt.xticks([]), plt.yticks([])
    plt.savefig(fname)
    plt.close()


def _pca2(Z):
    """Z (n, k) centred and projected on its first two principal axes."""
    Zc = Z - Z.mean(0, keepdims=True)
    _, _, Vt = np.linalg.svd(Zc, full_matrices=False)
    return Zc @ Vt[:2].T


def plot_latent_dynamics(ztL, order=1, fname='dynamics'):
    """PCA of latent trajectories, `<fname>_state.png` (and
    `<fname>_velocity.png` for order 2). ztL: (L, N, T, D) or (N, T, D)."""
    plt = _pyplot()
    if plt is None:
        return
    zt = np.asarray(ztL)
    if zt.ndim == 4:
        zt = zt[0]
    N, T, D = zt.shape
    q = D // 2 if order == 2 else D
    parts = [('state', zt[..., :q])]
    if order == 2:
        parts.append(('velocity', zt[..., q:]))
    for name, part in parts:
        P = _pca2(part.reshape(N * T, -1)).reshape(N, T, 2)
        plt.figure(figsize=(6, 6))
        for n in range(N):
            plt.plot(P[n, :, 0], P[n, :, 1], '-o', markersize=2, lw=0.8)
            plt.scatter(P[n, 0, 0], P[n, 0, 1], c='k', s=12, zorder=3)
        plt.title(f'latent {name} dynamics (PCA)')
        plt.savefig(f'{fname}_{name}.png')
        plt.close()


def plot_trace(elbo_meter, nll_meter, reg_kl_meter, inducing_kl_meter,
               save_dir, make_plot=True):
    """Loss traces: `elbo.npy`, `nll.npy`, `zkl.npy` and `inducingkl.npy`
    (the meters' values, float64) in `save_dir`, and
    `save_dir/plots/optimization_trace.png`."""
    names = ['elbo', 'nll', 'zkl', 'inducingkl']
    meters = [elbo_meter, nll_meter, reg_kl_meter, inducing_kl_meter]
    for name, m in zip(names, meters):
        np.save(os.path.join(save_dir, f'{name}.npy'),
                np.asarray(m.vals, dtype=np.float64))
    plt = _pyplot()
    if make_plot and plt is not None:
        fig, axs = plt.subplots(2, 2, figsize=(10, 8))
        for ax, name, m in zip(axs.flat, names, meters):
            ax.plot(m.iters, m.vals, lw=0.7)
            ax.set_title(name)
        fig.savefig(os.path.join(save_dir, 'plots', 'optimization_trace.png'))
        plt.close(fig)


def plot_params(hyperparam_meter, save_dir):
    """GP variance trace, `save_dir/plots/hyperparams.png`."""
    plt = _pyplot()
    if plt is None:
        return
    vals = np.stack([np.ravel(v) for v in hyperparam_meter.vals]) \
        if hyperparam_meter.vals else np.zeros((0, 1))
    plt.figure(figsize=(7, 4))
    for d in range(vals.shape[1] if vals.size else 0):
        plt.plot(hyperparam_meter.iters, vals[:, d], lw=0.8,
                 label=f'dim {d}')
    plt.title('GP signal variance')
    plt.legend(fontsize=6)
    plt.savefig(os.path.join(save_dir, 'plots', 'hyperparams.png'))
    plt.close()


def plot_vae_embeddings(mus, labels, n_classes, output_path,
                        fname='vae_embeddings_pca.png'):
    """PCA scatter of encoder means coloured by rotation-angle label."""
    plt = _pyplot()
    if plt is None:
        return
    P = _pca2(np.asarray(mus))
    plt.figure(figsize=(6, 6))
    sc = plt.scatter(P[:, 0], P[:, 1], c=np.asarray(labels), s=6,
                     cmap='twilight')
    plt.colorbar(sc, label='angle index')
    plt.title('VAE latent embeddings (PCA)')
    plt.savefig(os.path.join(output_path, fname))
    plt.close()


def visualize_embeddings(mus, labels, n_classes, output_path,
                         fname='vae_embeddings_tsne.png'):
    """t-SNE scatter of encoder means (PCA where sklearn's t-SNE does not
    run)."""
    plt = _pyplot()
    if plt is None:
        return
    try:
        from sklearn.manifold import TSNE
        E = TSNE(n_components=2, init='pca',
                 perplexity=min(30, max(5, len(mus) // 10))
                 ).fit_transform(np.asarray(mus))
    except Exception:
        E = _pca2(np.asarray(mus))
    plt.figure(figsize=(6, 6))
    sc = plt.scatter(E[:, 0], E[:, 1], c=np.asarray(labels), s=6,
                     cmap='twilight')
    plt.colorbar(sc, label='angle index')
    plt.title('VAE latent embeddings (t-SNE)')
    plt.savefig(os.path.join(output_path, fname))
    plt.close()


def visualize_output(x, y, output_path, fname='vae_reconstructions.png'):
    """Input vs VAE reconstruction grid of up to 16 frames; returns the
    reconstruction MSE, mean((x - y)^2) over all of x and y."""
    x, y = np.asarray(x), np.asarray(y)
    mse = float(np.mean((x - y) ** 2))
    plt = _pyplot()
    if plt is None:
        return mse
    n = min(16, x.shape[0])
    fig, axs = plt.subplots(2, n, figsize=(n, 2.4), squeeze=False)
    for i in range(n):
        axs[0, i].imshow(_img(x[i]), cmap='gray')
        axs[1, i].imshow(_img(y[i]), cmap='gray')
        axs[0, i].axis('off'), axs[1, i].axis('off')
    fig.suptitle(f'VAE reconstructions (MSE {mse:.4f})')
    fig.savefig(os.path.join(output_path, fname))
    plt.close(fig)
    return mse


def plot_trace_vae(elbo_meter, nll_meter, reg_kl_meter, output_path):
    """VAE-pretraining loss traces, `output_path/plots/vae_trace.png`."""
    plt = _pyplot()
    if plt is None:
        return
    fig, axs = plt.subplots(1, 3, figsize=(12, 3.5))
    for ax, name, m in zip(axs, ['elbo', 'nll', 'kl'],
                           [elbo_meter, nll_meter, reg_kl_meter]):
        ax.plot(m.iters, m.vals, lw=0.7)
        ax.set_title(name)
    fig.savefig(os.path.join(output_path, 'plots', 'vae_trace.png'))
    plt.close(fig)


def log_left_out(logger, fnames):
    """Where matplotlib does not import, log one line naming the PNGs of
    `fnames` (paths, repeats allowed) that were therefore not written."""
    if not available():
        names = sorted({os.path.basename(f) for f in fnames})
        logger.info('matplotlib does not import: figures left out: %s',
                    ', '.join(names))
