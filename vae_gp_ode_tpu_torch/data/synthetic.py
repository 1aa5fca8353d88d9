"""Synthetic rotating-digit sequences (port of
`vae_gp_ode_tpu/data/synthetic.py`, sequence generator only).

Without `rot-mnist.mat` in the repository, both packages train on
procedurally drawn '3'-like glyphs rotated through T uniform angles: the
shapes, value range and rotation structure of rot-MNIST. Rotation is
scipy's (bilinear, `reshape=False`, clipped to [0, 1]); the JAX package's
native C++ rotation matches it to 1e-5 and is not ported (ROADMAP Queue A
item 9).
"""

import numpy as np


def _draw_digit3(rng, size=28):
    """Draw a '3'-like glyph: two stacked right-open arcs, with small
    random thickness/scale/offset variation per instance."""
    img = np.zeros((size, size), np.float32)
    cx = size / 2 + rng.uniform(-1.0, 1.0)
    cy = size / 2 + rng.uniform(-1.0, 1.0)
    r = size * 0.22 * rng.uniform(0.9, 1.1)
    thick = rng.uniform(1.2, 1.9)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)

    for sign in (-1.0, 1.0):
        ay = cy + sign * r * 0.85
        d = np.sqrt((xx - cx) ** 2 + (yy - ay) ** 2)
        ring = np.exp(-((d - r) ** 2) / (2 * thick ** 2))
        # keep the right-open part of the arc (angle gate)
        ang = np.arctan2(yy - ay, xx - cx)
        gate = np.cos(ang - sign * 0.35) > -0.45
        img = np.maximum(img, ring * gate)

    img = np.clip(img * rng.uniform(0.95, 1.15), 0.0, 1.0)
    return img


def rotate_image(img, angle_deg):
    """Rotate one (H, W) image by `angle_deg` (scipy.ndimage.rotate,
    bilinear, reshape=False), clipped to [0, 1]."""
    from scipy.ndimage import rotate
    return np.clip(rotate(img, angle_deg, reshape=False, order=1), 0.0, 1.0)


def make_rotating_sequences(n_sequences, T=16, size=28, seed=0,
                            start_angle_zero=True, n_glyphs=None):
    """Generate (N, T, size*size) float32 in [0, 1]: each sequence is one
    glyph rotated through T uniform angles covering a full turn, from the
    same `np.random.RandomState(seed)` stream as the JAX package.

    `n_glyphs`: None/0 draws a fresh glyph per sequence; a positive int
    draws that many and assigns them round-robin (a closed-set ablation).
    """
    rng = np.random.RandomState(seed)
    n_bases = n_sequences if not n_glyphs else min(int(n_glyphs),
                                                   n_sequences)
    pool = np.stack([_draw_digit3(rng, size) for _ in range(n_bases)])
    bases = pool[np.arange(n_sequences) % n_bases]
    if start_angle_zero:
        offsets = np.zeros(n_sequences, np.float32)
    else:
        offsets = rng.uniform(0, 360, n_sequences).astype(np.float32)

    X = np.zeros((n_sequences, T, size * size), np.float32)
    angles = np.arange(T) * (360.0 / T)
    for n in range(n_sequences):
        for t in range(T):
            X[n, t] = rotate_image(bases[n],
                                   angles[t] + offsets[n]).reshape(-1)
    return X
