"""The plain reference of the thumbnail cell: where each thumbnail's content
truly lies, from the seeded turns and shifts that made the stack (no
program code, no program output but the answers it is asked to judge).

Thumbnail z shows, at its pixel p, the base texture at
cb + R(angle_z) (p - c) + t_z (``inputs/thumb_stack.py``). So the content
at p1 of thumbnail z1 is at the p0 of thumbnail z0 with
R0 (p0 - c) + t0 = R1 (p1 - c) + t1.
"""

import math

import torch


def _rot(deg, dtype):
    a = math.radians(float(deg))
    return torch.tensor([[math.cos(a), -math.sin(a)],
                         [math.sin(a), math.cos(a)]], dtype=dtype)


def truth_xy0(size, angles, shifts, z0, z1, xy1, dtype=torch.float64):
    """Thumbnail-px positions in z0 of the thumbnail-px points ``xy1``
    (N, 2) of z1, computed in ``dtype`` throughout."""
    xy1 = torch.as_tensor(xy1).to(dtype)
    t = torch.as_tensor(shifts).to(dtype)
    c = torch.tensor((size - 1) / 2.0, dtype=dtype)
    q = (xy1 - c) @ _rot(angles[z1], dtype).T + (t[z1] - t[z0])
    return q @ _rot(angles[z0], dtype) + c


def grid_points(size, angles, shifts, z0, z1, pitch, margin):
    """The reference's sample points (thumbnail px of z1): a grid of
    ``pitch`` over the thumbnail less ``margin``, where the truth in z0
    also lies at least ``margin`` inside."""
    g = torch.arange(margin, size - 1 - margin + 1e-9, pitch,
                     dtype=torch.float64)
    gy, gx = torch.meshgrid(g, g, indexing='ij')
    q = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    p0 = truth_xy0(size, angles, shifts, z0, z1, q)
    inside = ((p0 >= margin) & (p0 <= size - 1 - margin)).all(dim=1)
    return q[inside]
