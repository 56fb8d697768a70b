"""A serial-section stack from the seed (copied from ``chip_smoke.py``
``make_stack``; sizes from the configuration's ``deployment``).

Section z at mip-0 pixel p shows the base texture at p + margin + d_z(p),
where d_z is the cumulative drift of z's steps plus z times a smooth warp.
Each axis's steps are one fixed set, the quantiles of N(0, drift_std) at
(k + 1/2) / (n - 1), in an order drawn from the seed (``chip_smoke.py``
draws them from N(0, 24 px)): every seed then gives its pairs the same
shifts in another order, so the work of a pass does not change with the
seed. The drift is centred on its range and, where that range would
reach past the margin, scaled down to fit.
"""

import math
from statistics import NormalDist

import numpy as np
import torch

from inputs.texture import bilinear, make_texture


def disp(d, z, drift, x, y, xp):
    """Displacement d_z at mip-0 pixel (x, y) of section z (arrays of the
    module ``xp``: numpy or torch)."""
    w = 2 * math.pi / d['warp_period']
    return (drift[z][0] + z * d['warp_amp'] * xp.sin(w * y),
            drift[z][1] + z * d['warp_amp'] * xp.cos(w * x))


def drift(d, n, seed):
    """(n, 2) cumulative drift of the stack, centred and kept inside the
    margin (less 2 px and the warp's reach)."""
    rng = np.random.default_rng(seed)
    q = NormalDist(0.0, d['drift_std'])
    fixed = np.array([q.inv_cdf((k + 0.5) / (n - 1)) for k in range(n - 1)])
    steps = np.zeros((n, 2))
    steps[1:, 0] = rng.permutation(fixed)
    steps[1:, 1] = rng.permutation(fixed)
    dr = np.cumsum(steps, axis=0)
    dr -= (dr.max(axis=0) + dr.min(axis=0)) / 2
    room = d['margin'] - 2 - (n - 1) * d['warp_amp']
    reach = np.abs(dr).max()
    if reach > room:
        dr *= room / reach
    return dr


def base(dev, d, seed):
    side = d['section'] + 2 * d['margin']
    return make_texture(dev, side, side, seed, blur=d['texture_blur'])


def section(dev, d, base_img, dr, z):
    """Section z (section, section) uint8 on the card."""
    n = d['section']
    g = torch.arange(n, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(g, g, indexing='ij')
    dx, dy = disp(d, z, dr, gx, gy, torch)
    img = bilinear(base_img, gx + d['margin'] + dx, gy + d['margin'] + dy)
    return torch.round(img).clamp(0, 255).to(torch.uint8)
