"""The plain reference of the align.render cell: a section rendered through
its piecewise-affine mesh and sampled by Lanczos-4, in plain PyTorch (no
program code, no kernel, no cache), in blocks so a 4096^2 tile fits.

The mesh is given as arrays: each vertex's position in the output frame
(the MOVING gear, world px) and in the source (the INITIAL gear, the
section's px), and the triangles. An output pixel (r, c) of the bbox
(x0, y0, x1, y1) sits at (x0 + c, y0 + r). It takes the triangle that holds
it, by the barycentric test l1 >= -eps, l2 >= -eps, l1 + l2 <= 1 + eps of
its output-frame position, the first in index order where several do
(every triangle weighs the same: no fold arbitration, no geodesic mask);
a pixel no triangle holds takes the fill value. Its source position is
the same barycentric combination of the triangle's source vertices (the
triangle's affine map), sampled by Lanczos-4 as ``cv2.remap`` samples at
``INTER_LANCZOS4`` with ``BORDER_CONSTANT``: the 8 x 8 source pixels from
floor(x) - 3 to floor(x) + 4 and from floor(y) - 3 to floor(y) + 4,
weighted by sinc(d) sinc(d / 4) at each tap's distance d, normalised to sum
1; a tap outside the source reads the fill value. The result is rounded
and saturated to uint8.

Departures from ``cv2.remap`` (and so from what feabas renders):
- like ``cv2.remap``, each source coordinate is snapped to 1/32 px
  (``INTER_BITS`` 5; round half to even) and the weights are those of the
  snapped fraction; ``cv2.remap`` sums uint8 taps with 15-bit fixed-point
  weights, this sums them in ``dtype`` (1 LSB apart on a few pixels in a
  thousand);
- rounding to uint8 is half to even (``cv2.remap``'s fixed point rounds
  half up);
- feabas's host route crops the source 2 px past a block's source
  coordinates, so a tap beyond that crop reads the fill value there; this
  reads the whole section (it differs at the outermost px of a block, by a
  few LSB at most: the outer taps weigh under 2%);
- the barycentric test and the affine map run in ``dtype`` on positions
  taken, in float64, relative to the block's origin and to a whole px near
  the block's source (so their magnitudes stay near the block's size, as
  the card's block-local tables keep them), not in f64 (feabas's host
  rasterizer): at a triangle edge another triangle may win, whose affine
  map agrees there to well under 1/32 px.
"""

import math

import numpy as np
import torch

EPS = 1e-9
FRAC = 32
TAPS = 8


def lanczos4_weights(dtype=torch.float32, device=None):
    """(FRAC, TAPS): row f the weights of the fraction f / FRAC, tap i at
    distance f / FRAC + 3 - i, normalised to sum 1 (float64, then
    ``dtype``); at fraction 0 the pixel itself alone."""
    d = (torch.arange(1, FRAC, dtype=torch.float64)[:, None] / FRAC + 3
         - torch.arange(TAPS, dtype=torch.float64)[None])
    w = (torch.sin(math.pi * d) * torch.sin(math.pi * d / 4)
         / (math.pi ** 2 * d ** 2 / 4))
    w = torch.cat([torch.eye(TAPS, dtype=torch.float64)[3:4],
                   w / w.sum(dim=1, keepdim=True)])
    return w.to(dtype=dtype, device=device)


def _sample(src, xs, ys, fillval, lw, origin=(0, 0)):
    """Lanczos-4 samples of ``src`` (H, W) at (xs, ys) (any shape, in the
    weights' dtype) + ``origin`` (whole px): taps outside the source read
    ``fillval``."""
    H, W = src.shape
    dt = lw.dtype
    xq = torch.round(xs * FRAC) / FRAC
    yq = torch.round(ys * FRAC) / FRAC
    x0 = torch.floor(xq)
    y0 = torch.floor(yq)
    wx = lw[((xq - x0) * FRAC).long().clamp(0, FRAC - 1)]   # (..., 8)
    wy = lw[((yq - y0) * FRAC).long().clamp(0, FRAC - 1)]
    # keep the tap indices inside int64 for coordinates far outside
    ix = (x0 + origin[0]).clamp(-8, W + 8).long()[..., None] - 3 \
        + torch.arange(TAPS, device=xs.device)
    iy = (y0 + origin[1]).clamp(-8, H + 8).long() - 3
    fill = torch.tensor(float(fillval), dtype=dt, device=xs.device)
    okx = (ix >= 0) & (ix < W)
    out = torch.zeros(xs.shape, dtype=dt, device=xs.device)
    for r in range(TAPS):
        yy = iy + r
        ok = okx & ((yy >= 0) & (yy < H))[..., None]
        v = src[yy.clamp(0, H - 1)[..., None], ix.clamp(0, W - 1)].to(dt)
        v = torch.where(ok, v, fill)
        out = out + wy[..., r] * (wx * v).sum(dim=-1)
    return out


def render_block(src, tgt, srcv, tris, bbox, fillval=0.0,
                 dtype=torch.float32):
    """(h, w) uint8 render of the output bbox (x0, y0, x1, y1) and its
    (h, w) coverage: ``src`` (H, W) the section on the device the output
    is made on, ``tgt`` / ``srcv`` (V, 2) the vertices' output-frame and
    source positions, ``tris`` (T, 3). Computed in ``dtype`` throughout."""
    dev = src.device
    x0, y0, x1, y1 = (int(v) for v in bbox)
    h, w = y1 - y0, x1 - x0
    tgt = torch.as_tensor(np.asarray(tgt), dtype=torch.float64)
    srcv = torch.as_tensor(np.asarray(srcv), dtype=torch.float64)
    tris = torch.as_tensor(np.asarray(tris), dtype=torch.int64)
    P = tgt[tris]                                      # (T, 3, 2)
    lo, hi = P.min(dim=1).values, P.max(dim=1).values
    sel = torch.nonzero((lo[:, 0] <= x1) & (hi[:, 0] >= x0 - 1)
                        & (lo[:, 1] <= y1) & (hi[:, 1] >= y0 - 1))[:, 0]
    # positions relative to the block's origin and to a whole px at the
    # block's source, in float64, before the cast to ``dtype``
    P = (P[sel] - torch.tensor([x0, y0], dtype=torch.float64)).to(
        dtype=dtype, device=dev)
    S = srcv[tris[sel]]
    so = torch.floor(S.reshape(-1, 2).min(dim=0).values) if len(sel) \
        else torch.zeros(2, dtype=torch.float64)
    S = (S - so).to(dtype=dtype, device=dev)
    gy, gx = torch.meshgrid(torch.arange(h, device=dev, dtype=dtype),
                            torch.arange(w, device=dev, dtype=dtype),
                            indexing='ij')
    sx = torch.zeros((h, w), dtype=dtype, device=dev)
    sy = torch.zeros((h, w), dtype=dtype, device=dev)
    cov = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for t in range(P.shape[0]):
        a, b, c = P[t]
        e1, e2 = b - a, c - a
        den = e1[0] * e2[1] - e1[1] * e2[0]
        if float(den) == 0.0:
            continue
        px, py = gx - a[0], gy - a[1]
        l1 = (px * e2[1] - py * e2[0]) / den
        l2 = (py * e1[0] - px * e1[1]) / den
        take = (~cov & (l1 >= -EPS) & (l2 >= -EPS) & (l1 + l2 <= 1 + EPS))
        sa, sb, sc = S[t]
        sx = torch.where(take, sa[0] + l1 * (sb[0] - sa[0])
                         + l2 * (sc[0] - sa[0]), sx)
        sy = torch.where(take, sa[1] + l1 * (sb[1] - sa[1])
                         + l2 * (sc[1] - sa[1]), sy)
        cov |= take
    lw = lanczos4_weights(dtype, dev)
    val = _sample(src, sx, sy, fillval, lw, [int(v) for v in so])
    val = torch.where(cov, val, torch.tensor(float(fillval), dtype=dtype,
                                             device=dev))
    out = torch.clamp(torch.round(val.to(torch.float32)), 0, 255)
    return out.to(torch.uint8), cov


def render(src, tgt, srcv, tris, bbox, fillval=0.0, dtype=torch.float32,
           block=1024):
    """``render_block`` over the bbox in blocks of ``block`` px a side."""
    x0, y0, x1, y1 = (int(v) for v in bbox)
    out = torch.empty((y1 - y0, x1 - x0), dtype=torch.uint8,
                      device=src.device)
    cov = torch.empty((y1 - y0, x1 - x0), dtype=torch.bool,
                      device=src.device)
    for by in range(y0, y1, block):
        for bx in range(x0, x1, block):
            bb = (bx, by, min(bx + block, x1), min(by + block, y1))
            o, c = render_block(src, tgt, srcv, tris, bb, fillval, dtype)
            out[by - y0:bb[3] - y0, bx - x0:bb[2] - x0] = o
            cov[by - y0:bb[3] - y0, bx - x0:bb[2] - x0] = c
    return out, cov
