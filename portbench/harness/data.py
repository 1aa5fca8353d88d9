"""The traffic's data, made on the device from a seed: rotating '3'-like
glyphs at rot-MNIST's shapes (a copy of the port's `data.synthetic`
generator, vectorised: two stacked right-open arcs with random centre,
radius, thickness and brightness, rotated through T uniform angles of a
full turn, bilinear about the image centre with zero fill), normalised
with the MNIST mean and standard deviation as the training CLI feeds
them. Index tables (epoch permutations, request batches) come from the
same seed."""

import math

import torch
import torch.nn.functional as F

#: streams of a run's seed: the data and index tables, the weights, the
#: model's noise, the sample of requests the check compares
DATA, WEIGHTS, NOISE, SAMPLE = 1, 2, 3, 4

MNIST_MEAN = 0.1307
MNIST_STD = 0.3081
SIZE = 28


def generator(seed, stream, device):
    """A torch.Generator on `device` for one named stream of `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def sync(device):
    """Wait for the card's queue (nothing on the CPU)."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def glyphs(n, gen, device):
    """(n, 28, 28) glyphs in [0, 1]."""
    u = torch.rand((n, 6), generator=gen, device=device)
    cx = SIZE / 2 + (2 * u[:, 0] - 1)
    cy = SIZE / 2 + (2 * u[:, 1] - 1)
    r = SIZE * 0.22 * (0.9 + 0.2 * u[:, 2])
    thick = 1.2 + 0.7 * u[:, 3]
    bright = 0.95 + 0.2 * u[:, 4]
    yy, xx = torch.meshgrid(torch.arange(SIZE, device=device,
                                         dtype=torch.float32),
                            torch.arange(SIZE, device=device,
                                         dtype=torch.float32), indexing='ij')
    img = torch.zeros((n, SIZE, SIZE), device=device)
    for sign in (-1.0, 1.0):
        ay = (cy + sign * r * 0.85)[:, None, None]
        dx = xx - cx[:, None, None]
        dy = yy - ay
        d = torch.sqrt(dx * dx + dy * dy)
        ring = torch.exp(-(d - r[:, None, None]) ** 2
                         / (2 * thick[:, None, None] ** 2))
        gate = torch.cos(torch.atan2(dy, dx) - sign * 0.35) > -0.45
        img = torch.maximum(img, ring * gate)
    return torch.clamp(img * bright[:, None, None], 0.0, 1.0)


def rotating_sequences(n, T, gen, device):
    """(n, T, 1, 28, 28) normalised sequences: each glyph rotated through
    the angles 360 t / T."""
    base = glyphs(n, gen, device)
    ang = torch.arange(T, device=device, dtype=torch.float32) * (
        2 * math.pi / T)
    c, s = torch.cos(ang), torch.sin(ang)
    theta = torch.zeros((T, 2, 3), device=device)
    theta[:, 0, 0], theta[:, 0, 1] = c, -s
    theta[:, 1, 0], theta[:, 1, 1] = s, c
    grid = F.affine_grid(theta, (T, 1, SIZE, SIZE), align_corners=True)
    out = torch.empty((n, T, 1, SIZE, SIZE), device=device)
    for i in range(0, n, 256):
        b = base[i:i + 256]
        src = b[:, None, None].expand(-1, T, 1, SIZE, SIZE).reshape(
            -1, 1, SIZE, SIZE)
        g = grid.expand(b.shape[0], T, SIZE, SIZE, 2).reshape(
            -1, SIZE, SIZE, 2)
        out[i:i + 256] = F.grid_sample(
            src, g, mode='bilinear', padding_mode='zeros',
            align_corners=True).reshape(b.shape[0], T, 1, SIZE, SIZE)
    return (out.clamp(0.0, 1.0) - MNIST_MEAN) / MNIST_STD


def permutations(rows, n, gen, device):
    """(rows, n) int64: a random permutation of range(n) per row."""
    return torch.argsort(torch.rand((rows, n), generator=gen, device=device),
                         dim=1)
