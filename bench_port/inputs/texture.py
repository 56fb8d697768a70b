"""Seeded inputs made on the card: the band-limited texture every cell's
images are cut or warped from, and plain bilinear sampling.

Copied from ``chip_smoke.py`` (``make_texture``; the sampling of
``make_stack``), so that the benchmark's inputs stay fixed whatever later
changes the program or that script makes.
"""

import numpy as np
import torch
import torch.nn.functional as F


def seeds(seed, n):
    """``n`` independent 63-bit seeds drawn from the run's ``seed``."""
    state = np.random.SeedSequence(int(seed)).generate_state(2 * n, np.uint32)
    return [int(state[2 * k]) << 31 | int(state[2 * k + 1]) >> 1
            for k in range(n)]


def make_texture(dev, H, W, seed, blur=2.0):
    """Band-limited uint8 texture (H, W) on the card: seeded normal noise,
    Gaussian blur (sigma ``blur`` px), mean 128, std 40."""
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((1, 1, H, W), generator=g, device=dev)
    r = int(4 * blur)
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1, device=dev) / blur) ** 2)
    k = k / k.sum()
    img = F.conv2d(F.pad(noise, (r, r, r, r), mode='reflect'),
                   k.reshape(1, 1, 1, -1))
    img = F.conv2d(img, k.reshape(1, 1, -1, 1))[0, 0]
    img = img / img.std() * 40.0 + 128.0
    return torch.clamp(img, 0, 255).to(torch.uint8)


def bilinear(img, xs, ys, fillval=0.0):
    """Sample ``img`` (H, W) at pixel coordinates (xs, ys), pixel (i, j) at
    x = j, y = i; outside [0, W-1] x [0, H-1] ``fillval``. Computed in the
    dtype of xs."""
    H, W = img.shape
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx, fy = xs - x0, ys - y0
    valid = (xs >= 0) & (ys >= 0) & (xs <= W - 1) & (ys <= H - 1)
    xi = x0.long().clamp(0, W - 1)
    yi = y0.long().clamp(0, H - 1)
    xj = (xi + 1).clamp(max=W - 1)
    yj = (yi + 1).clamp(max=H - 1)
    f = img.to(xs.dtype)
    out = (f[yi, xi] * (1 - fx) * (1 - fy) + f[yi, xj] * fx * (1 - fy)
           + f[yj, xi] * (1 - fx) * fy + f[yj, xj] * fx * fy)
    return torch.where(valid, out, torch.full_like(out, fillval))
