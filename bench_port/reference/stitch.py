"""The plain reference of the stitch cell: the tiles' true positions in the
seeded world, and the world itself sampled where the stitched canvas puts
each pixel (no program code; the program's answers are only judged).

A stitched section is defined up to a translation: the solve fixes none.
The canvas offset g is the mean of the placed tiles' offsets from their
true positions; a placement is judged by its distance from true + g, and
canvas pixel c is the world at c - g.
"""

import numpy as np
import torch

from inputs.texture import bilinear


def expected_overlaps(stage_bb, min_width):
    """Tile pairs (i < j) whose stage rectangles overlap by ``min_width``
    px or more both ways: the overlaps a stitch matches."""
    out = []
    for i in range(len(stage_bb)):
        for j in range(i + 1, len(stage_bb)):
            w = min(stage_bb[i][2], stage_bb[j][2]) - max(stage_bb[i][0], stage_bb[j][0])
            h = min(stage_bb[i][3], stage_bb[j][3]) - max(stage_bb[i][1], stage_bb[j][1])
            if min(w, h) >= min_width:
                out.append((i, j))
    return out


def overlap_points(true_bb, i, j, pitch, margin):
    """World points on a grid of ``pitch`` over the true overlap of tiles
    i and j, ``margin`` px inside it (at least its centre)."""
    x0 = max(true_bb[i][0], true_bb[j][0]) + margin
    y0 = max(true_bb[i][1], true_bb[j][1]) + margin
    x1 = min(true_bb[i][2], true_bb[j][2]) - margin
    y1 = min(true_bb[i][3], true_bb[j][3]) - margin
    xs = np.arange(x0, x1 + 1e-9, pitch) if x1 >= x0 else np.array([(x0 + x1) / 2])
    ys = np.arange(y0, y1 + 1e-9, pitch) if y1 >= y0 else np.array([(y0 + y1) / 2])
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel()], -1)


def match_world_error(xy0, xy1, ti, tj, dtype=torch.float64):
    """|(xy0 + T_i) - (xy1 + T_j)| of tile-local matches, computed in
    ``dtype``: the distance between the world points a match pairs."""
    a = torch.as_tensor(xy0).to(dtype) + torch.as_tensor(ti[:2]).to(dtype)
    b = torch.as_tensor(xy1).to(dtype) + torch.as_tensor(tj[:2]).to(dtype)
    return torch.linalg.norm((a - b).to(torch.float64), dim=1).numpy()


def placement_errors(placed, true_bb):
    """(g, |placed - true - g| per tile, the larger axis) of placed tile
    origins (N, 2)."""
    off = np.asarray(placed, np.float64) - np.asarray(true_bb)[:, :2]
    g = off.mean(axis=0)
    return g, np.abs(off - g).max(axis=1)


def canvas(world, true_bb, g, bbox, dtype=torch.float64, border=3):
    """(expected, compared) over the canvas ``bbox`` (x0, y0, x1, y1): the
    world sampled bilinearly at c - g for each canvas pixel c, rounded to
    uint8 values, computed in ``dtype``; and the pixels whose world point
    lies ``border`` px or more inside some true tile."""
    dev = world.device
    x0, y0, x1, y1 = bbox
    xs = torch.arange(x0, x1, device=dev, dtype=dtype) - torch.tensor(g[0], dtype=dtype)
    ys = torch.arange(y0, y1, device=dev, dtype=dtype) - torch.tensor(g[1], dtype=dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    out = torch.round(bilinear(world, gx, gy)).clamp(0, 255).to(torch.float32)
    seen = torch.zeros(gx.shape, dtype=torch.bool, device=dev)
    for tx0, ty0, tx1, ty1 in np.asarray(true_bb):
        seen |= ((gx >= tx0 + border) & (gx <= tx1 - 1 - border)
                 & (gy >= ty0 + border) & (gy <= ty1 - 1 - border))
    return out, seen
