"""The montage blend (``ops/montage_render.montage_blend``: one output
block from per-tile triangle tables and packed sources), counted as
``chip_smoke.py`` ``montage_bound`` counts it: the output, one source byte
per (pixel, covering tile) (two with PYRAMID) and the tables, each once;
the FLOP of the rows the cell cull keeps, of the covered samples and of the
output. The cull and the coverage are recounted here in plain PyTorch from
the call's tables, after the window (copies of the program's plain
``cell_cull_plain`` / ``covered_pixels_plain`` rules)."""

import torch

from roofline.common import bound

KERNEL = 'montage_blend'
# the device kernel's name in the trace (its ``__global__`` in csrc/)
NAME = r'\bblend_kernel\b'
MODULE, ATTR = 'feabas_tpu_torch.ops.montage_render', 'montage_blend'

CELL = 64
EPS = 1e-9
ROW_FLOP, COVER_FLOP, PYRAMID_FLOP, OUT_FLOP = 13, 52, 15, 7


def _affine(a, x, b, y, c):
    return a * x + b * y + c


def kept_rows(tables, cands, ncx):
    """Rows of the cells' candidate tiles that some pixel of the cell may
    be inside (corner rule on l1, l2) and whose weight is not -inf."""
    C, K = cands.shape
    dev = tables.device
    cell = torch.arange(C, device=dev)
    xs = ((cell % ncx) * CELL).to(torch.float32)[:, None]
    ys = ((cell // ncx) * CELL).to(torch.float32)[:, None]
    corners = [(x, y) for y in (ys, ys + (CELL - 1)) for x in (xs, xs + (CELL - 1))]
    n = 0
    for k in range(K):
        idx = cands[:, k]
        tab = tables[torch.clamp(idx, min=0)]

        def ext(j):
            at = torch.stack([_affine(tab[..., j], x, tab[..., j + 1], y,
                                      tab[..., j + 2]) for x, y in corners])
            return at.amax(dim=0), at.amin(dim=0)
        hi1, lo1 = ext(0)
        hi2, lo2 = ext(3)
        keep = ((idx >= 0)[:, None] & (tab[..., 12] > -torch.inf)
                & (hi1 >= -EPS) & (hi2 >= -EPS) & (lo1 + lo2 <= 1.0 + EPS))
        n += int(keep.sum())
    return n


def covered_samples(tables, cands, ncx):
    """(pixel, candidate tile) pairs that some row of the tile covers."""
    live = torch.nonzero((cands >= 0).any(dim=1)).reshape(-1)
    ar = torch.arange(CELL, dtype=torch.float32, device=tables.device)
    px = ((live % ncx) * CELL).to(torch.float32)[:, None, None] + ar[None, None, :]
    py = ((live // ncx) * CELL).to(torch.float32)[:, None, None] + ar[None, :, None]
    n = 0
    for k in range(cands.shape[1]):
        idx = cands[live, k]
        tab = tables[torch.clamp(idx, min=0)]
        cov = torch.zeros((live.numel(), CELL, CELL), dtype=torch.bool,
                          device=tables.device)
        for j in range(tab.shape[1]):
            row = tab[:, j, :, None, None]
            l1 = row[:, 0] * px + row[:, 1] * py + row[:, 2]
            l2 = row[:, 3] * px + row[:, 4] * py + row[:, 5]
            cov |= ((l1 >= -EPS) & (l2 >= -EPS) & (l1 + l2 <= 1.0 + EPS)
                    & (row[:, 12] > -torch.inf))
        n += int((cov & (idx >= 0)[:, None, None]).sum())
    return n


def call_bound(pk, gmap, tables, aux, cands, ncy, ncx, out_kind, pyramid):
    px = ncy * ncx * CELL ** 2
    kept = kept_rows(tables, cands, ncx)
    cov = covered_samples(tables, cands, ncx)
    nbytes = (px * (1 if out_kind == 'u8' else 4) + cov * (2 if pyramid else 1)
              + 4 * (tables.numel() + aux.numel())
              + 8 * (cands.numel() + gmap.numel()))
    flop = (kept * CELL ** 2 * ROW_FLOP + px * OUT_FLOP
            + cov * (COVER_FLOP + (PYRAMID_FLOP if pyramid else 0)))
    return bound(pk, flop, nbytes)


def wrap(orig, record):
    """The bound needs a plain raster of the block's rows, too slow to run
    inside the traced window: each call records a deferred bound, which
    the harness works out after the window from the tables kept."""
    def montage_blend(srcs, lows, gmap, tables, aux, cands, fillval, ncy, ncx,
                      out_kind='u8', pyramid=False):
        if tables.device.type != 'cuda':
            return orig(srcs, lows, gmap, tables, aux, cands, fillval, ncy,
                        ncx, out_kind, pyramid)
        pk = record.peaks

        def later():
            return call_bound(pk, gmap, tables, aux, cands, ncy, ncx,
                              out_kind, pyramid)
        return record(KERNEL, later, orig, srcs, lows, gmap, tables, aux,
                      cands, fillval, ncy, ncx, out_kind, pyramid)
    return montage_blend
