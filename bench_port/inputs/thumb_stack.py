"""A stack of turned section thumbnails from the seed (copied from
``chip_smoke.py`` ``make_turned_stack``; sizes and motions from the
configuration's ``deployment``).

Section z's thumbnail pixel p shows the base texture at
cb + R(angle_z) (p - c) + t_z: c the thumbnail's centre, cb the base's,
angle_z the deployment's turn of z plus a draw of U(-jitter, jitter)
degrees, t_z a draw of N(0, shift_std) thumbnail px a axis. The thumbnails
are made directly at their mip (no mip-0 section is made).
"""

import math

import numpy as np
import torch

from inputs.texture import bilinear, make_texture


def motions(d, n, seed):
    """(angles in degrees (n,), shifts (n, 2)) of the stack's n sections."""
    rng = np.random.default_rng(seed)
    turns = np.resize(np.asarray(d['turns_deg'], np.float64), n)
    jitter = d['turn_jitter_deg']
    angles = rng.uniform(-jitter, jitter, n) + turns
    shifts = rng.normal(0.0, d['shift_std'], (n, 2))
    return angles, shifts


def sections(dev, d, angles, shifts, seed):
    """The thumbnails as host (size, size) uint8 arrays, made on ``dev``."""
    size = d['thumbnail']
    n = int(math.ceil(size * math.sqrt(2.0) + 2 * np.abs(shifts).max())) + 16
    base = make_texture(dev, n, n, seed, blur=d['texture_blur'])
    c, cb = (size - 1) / 2.0, (n - 1) / 2.0
    g = torch.arange(size, dtype=torch.float32, device=dev) - c
    gy, gx = torch.meshgrid(g, g, indexing='ij')
    out = []
    for a_deg, (tx, ty) in zip(angles, shifts):
        a = math.radians(a_deg)
        ca, sa = math.cos(a), math.sin(a)
        img = bilinear(base, cb + ca * gx - sa * gy + float(tx),
                       cb + sa * gx + ca * gy + float(ty))
        out.append(torch.round(img).clamp(0, 255).to(torch.uint8)
                   .cpu().numpy())
    return out
