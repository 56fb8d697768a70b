"""The plain reference of the align cells: where each section's content
truly lies, from the seeded drift and warp that made the stack (no program
code, no program output but the answers it is asked to judge).

Section z shows, at its mip-0 pixel p, the base texture at p + margin +
d_z(p) (``inputs/align_stack.py``). So the content at p1 of section z1 is
at the p0 of section z0 with p0 + d_z0(p0) = p1 + d_z1(p1).
"""

import torch

from inputs.align_stack import disp


def truth_xy0(d, dr, z0, z1, xy1, scale, dtype=torch.float64):
    """Working-px positions in section z0 of the working-px points ``xy1``
    (N, 2) of section z1 (one working px spans ``scale`` mip-0 px, pixel
    centres kept), computed in ``dtype`` throughout."""
    xy1 = torch.as_tensor(xy1).to(dtype)
    dr_t = torch.as_tensor(dr).to(dtype)
    half = torch.tensor((scale - 1) / 2, dtype=dtype)
    p1 = xy1 * scale + half
    dx1, dy1 = disp(d, z1, dr_t, p1[:, 0], p1[:, 1], torch)
    target = p1 + torch.stack([dx1, dy1], -1)
    p0 = target.clone()
    for _ in range(8):
        dx0, dy0 = disp(d, z0, dr_t, p0[:, 0], p0[:, 1], torch)
        p0 = target - torch.stack([dx0, dy0], -1)
    return (p0 - half) / scale


def grid_points(d, dr, z0, z1, scale, pitch, margin):
    """The reference's sample points (working px of section z1): a grid of
    ``pitch`` over the section less ``margin``, where the truth in z0 also
    lies at least ``margin`` inside."""
    n = d['section'] / scale
    g = torch.arange(margin, n - margin + 1e-9, pitch, dtype=torch.float64)
    gy, gx = torch.meshgrid(g, g, indexing='ij')
    q = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    t = truth_xy0(d, dr, z0, z1, q, scale)
    inside = ((t >= margin) & (t <= n - margin)).all(dim=1)
    return q[inside]
