"""One stitch section from the seed: a world texture cut into a grid of
overlapping tiles at jittered true positions (copied from ``chip_smoke.py``
``make_grid``; sizes from the configuration's ``deployment``)."""

from statistics import NormalDist

import numpy as np

from inputs.texture import make_texture


def world_shape(d):
    H = 2 * d['margin'] + d['rows'] * d['tile_h'] - (d['rows'] - 1) * d['overlap_y']
    W = 2 * d['margin'] + d['cols'] * d['tile_w'] - (d['cols'] - 1) * d['overlap_x']
    return H, W


def make_world(dev, d, seed):
    """The section's world texture (H, W) uint8 on the card."""
    H, W = world_shape(d)
    return make_texture(dev, H, W, seed, blur=d['texture_blur'])


def layout(d, seed):
    """(true (N, 4), stage (N, 4)) tile bboxes x0, y0, x1, y1 in world px:
    the stage grid, and the true positions off it by a jitter rounded to
    whole px (tile 0 not jittered). Each axis's jitters are one fixed set,
    the quantiles of N(0, jitter) at (k + 1/2) / (N - 1), in an order drawn
    from the seed (``chip_smoke.py`` draws them from N(0, 3 px)), so every
    seed gives its section the same stage errors in another order."""
    rng = np.random.default_rng(seed)
    n = d['rows'] * d['cols'] - 1
    q = NormalDist(0.0, d['jitter'])
    fixed = [q.inv_cdf((k + 0.5) / n) for k in range(n)]
    jit = np.zeros((n + 1, 2))
    jit[1:, 0] = rng.permutation(fixed)
    jit[1:, 1] = rng.permutation(fixed)
    true_bb, stage_bb = [], []
    for r in range(d['rows']):
        for c in range(d['cols']):
            x0 = d['margin'] + c * (d['tile_w'] - d['overlap_x'])
            y0 = d['margin'] + r * (d['tile_h'] - d['overlap_y'])
            jx, jy = jit[r * d['cols'] + c]
            xt, yt = int(round(x0 + jx)), int(round(y0 + jy))
            true_bb.append((xt, yt, xt + d['tile_w'], yt + d['tile_h']))
            stage_bb.append((x0, y0, x0 + d['tile_w'], y0 + d['tile_h']))
    return np.asarray(true_bb, float), np.asarray(stage_bb, float)


def tiles(world, true_bb):
    """Host uint8 tiles cut from the world at their true positions."""
    out = []
    for x0, y0, x1, y1 in true_bb.astype(int):
        out.append(world[y0:y1, x0:x1].cpu().numpy())
    return out
