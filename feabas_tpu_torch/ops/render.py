"""Device mesh rendering (counterpart of ``feabas_tpu/ops/render.py``).

The host builds, for every output block, a small table of triangle
coefficients in block-local coordinates (barycentric inside-test rows and
the target->source affine of each candidate triangle, f64 on the host,
f32 on the device) and, for dense blocks, a table of candidate rows per
128-px cell. ``raster_blocks`` then rasterizes a batch of blocks, samples
the source at every pixel's winning affine coordinate and returns the
blocks in the output dtype with one coverage flag each.

On a CUDA tensor ``raster_blocks`` launches the hand-written kernel
(``csrc/mesh_raster.cu``) once per batch, for flat and cell-binned tables,
for one shared source or per-block source crops; on a CPU tensor it runs
``raster_blocks_plain``, the same arithmetic in plain PyTorch.
``tile_cull_plain`` states the kernel's per-tile candidate cull.

Two sampling modes (``INTERPS``): ``'linear'``, the bilinear tap, and
``'lanczos4'``, OpenCV's ``INTER_LANCZOS4`` (``cv2.remap`` at the
renderer's ``remap_interp: LANCZOS``): 8 x 8 taps from floor(x) - 3 to
floor(x) + 4, weighted by ``lanczos4_table``, each tap outside the source's
real extents reading the fill value (``BORDER_CONSTANT``). Both sample at
the winning coordinate snapped to 1/32 px, as ``cv2.remap`` snaps its map
(``INTER_BITS`` 5). Unlike ``cv2.remap``, which sums u8 taps with 15-bit
fixed-point weights, the Lanczos sum is taken in f32 (each product and
sum rounded alone, rows of 8 in order, then the 8 rows), then rounded and
saturated to u8 / u16 (f32 output is not clipped): it differs from
``cv2.remap`` by at most 1 LSB, on about 0.3% of u8 pixels. Source crops
reach ``_SRC_HALO`` px past a block's source coordinates, the taps' halo
and a margin of one. The optional mip chain (2x area averages with a
Gaussian pre-blur) runs in PyTorch after either, its blur through
``ops.dog.gaussian_blur``.

``DeviceRenderEngine`` is the host side: candidate selection, tables,
source crops or a resident whole-section source, grouping of same-shape
blocks, taken in order, into batches (``_group_cap``: a rule of block
size alone). Its candidate and table build runs in the span
``render.tables``; it counts each block it renders (``render.blocks``),
those rendered on a CUDA card (``render.device_blocks``) and the output
px it samples by Lanczos-4 (``render.lanczos_px``).
"""

import ctypes

import numpy as np
import torch

from feabas_tpu_torch import build, state, trace
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch.ops import dog
from feabas_tpu_torch.ops.warp import bilinear_sample

# barycentric inside-test epsilon (native/rasterize.cpp:28)
_EPS = 1e-9
# table rows pad to a multiple of this
_CHUNK = 8
# cell edge in px of the cell-binned raster, and the block triangle count
# above which cells are used
_CELL = 128
_CELL_MIN_TRIS = 32
# source / output block dims quantize to these multiples
_SRC_ALIGN = 256
_OUT_ALIGN = 512
# sampling modes; a source crop reaches this far past a block's source
# coordinates: the last tap after floor(x) (1 bilinear, 4 Lanczos-4) and
# one px of margin (the snap to 1/32 px), as far before floor(x) as after
_SRC_HALO = {'linear': 2, 'lanczos4': 5}
INTERPS = tuple(_SRC_HALO)
# Lanczos-4: the 1/32 px fractions of a coordinate and the taps an axis
_FRAC = 32
_TAPS = 8
# sources at most this large stay device-resident across blocks
WHOLE_SRC_CAP = 256 * 1024 * 1024
# a batch groups blocks until it covers this many output pixels
_GROUP_TARGET_PIXELS = 1 << 20
_GROUP_CAP_MAX = 16

_OUT_KINDS = {'u8': (0, torch.uint8), 'u16': (1, torch.uint16),
              'f32': (2, torch.float32)}
# device -> (library, device index, raw current-stream lookup)
_LIBS = {}
# the Lanczos-4 weights: the table and its copy on each device
_LANCZOS = {}


def lanczos4_table():
    """(32, 8) float32: row f holds the Lanczos-4 weights of the fraction
    f / 32 px, tap i at distance d = f / 32 + 3 - i from the coordinate:
    sinc(d) sinc(d / 4), normalised to sum 1 in float64 and rounded to
    float32; row 0 is the coordinate's own pixel alone (OpenCV's
    ``interpolateLanczos4``, whose table ``cv2.remap`` indexes by the same
    1/32 px fraction)."""
    if 'table' not in _LANCZOS:
        d = (np.arange(1, _FRAC, dtype=np.float64)[:, None] / _FRAC + 3
             - np.arange(_TAPS)[None])
        w = (np.sin(np.pi * d) * np.sin(np.pi * d / 4)
             / (np.pi ** 2 * d ** 2 / 4))
        w = np.concatenate([np.eye(_TAPS)[3:4],
                            w / w.sum(axis=1, keepdims=True)])
        _LANCZOS['table'] = w.astype(np.float32)
    return _LANCZOS['table']


def _lanczos4_weights(dev):
    """``lanczos4_table`` as a tensor on ``dev``, made once a device."""
    key = str(dev)
    if key not in _LANCZOS:
        _LANCZOS[key] = torch.from_numpy(lanczos4_table()).to(dev)
    return _LANCZOS[key]


def _group_cap(block_pixels):
    """Blocks per batch: 4, or more small blocks until a batch covers
    ~``_GROUP_TARGET_PIXELS`` output pixels (at most ``_GROUP_CAP_MAX``)."""
    return max(4, min(_GROUP_TARGET_PIXELS // max(int(block_pixels), 1),
                      _GROUP_CAP_MAX))


def _flat_len(h, w, n_mips):
    """Pixels of a block and its mip levels, plus one coverage flag (the
    JAX package's packed output length)."""
    n = 0
    for lvl in range(n_mips + 1):
        n += (h >> lvl) * (w >> lvl)
    return n + 1


def _out_kind(dtype):
    dt = np.dtype(dtype)
    if dt == np.uint8:
        return 'u8'
    if dt == np.uint16:
        return 'u16'
    if dt.kind == 'f':
        return 'f32'
    return None


def _align_up(n, align, lo):
    return max(int(lo), int(-(-int(n) // align) * align))


# ------------------------------ plain version ------------------------------ #

def _affine(a, x, b, y, c):
    """a * x + b * y + c evaluated as fma(a, x, b * y) + c in f32, the
    contraction XLA applies to this expression (the kernel uses
    __fmaf_rn). The fma is taken in f64: the f32 product a * x is exact
    there, and the sum rounds to f64 and then to f32."""
    ax = a.to(torch.float64) * x.to(torch.float64)
    return (ax + (b * y).to(torch.float64)).to(torch.float32) + c


def _raster_state_plain(tables, cands, h, w, geodesic):
    """Per-pixel (score, sx, sy, smask, row) of a batch -- row is the
    winning table row, -1 where none won: tables (B, Tp, 14), cands
    (B, NC, K) or None. Mirrors _raster_core / _raster_core_cells."""
    B, Tp = tables.shape[:2]
    dev = tables.device
    f32 = torch.float32
    if cands is None:
        gx = torch.arange(w, dtype=f32, device=dev)[None, None, :]
        gy = torch.arange(h, dtype=f32, device=dev)[:, None][None]
        shape = (B, h, w)

        def rows_at(k):
            return tables[:, k]                          # (B, 14)

        def row_ids(k):
            return k

        def col(rows, j):
            return rows[:, j][:, None, None]
        n = Tp
    else:
        C = _CELL
        ncy, ncx = h // C, w // C
        n = cands.shape[-1]
        cand = cands.reshape(B, ncy, ncx, n).to(torch.int64)
        loc = torch.arange(C, dtype=f32, device=dev)
        gx = ((torch.arange(ncx, dtype=f32, device=dev) * C)[None, None, :, None, None]
              + loc[None, None, None, None, :])
        gy = ((torch.arange(ncy, dtype=f32, device=dev) * C)[None, :, None, None, None]
              + loc[None, None, None, :, None])
        shape = (B, ncy, ncx, C, C)
        bidx = torch.arange(B, device=dev)[:, None, None]

        def rows_at(k):
            return tables[bidx, cand[..., k]]            # (B, ncy, ncx, 14)

        def row_ids(k):
            return cand[..., k][..., None, None].to(torch.int32)

        def col(rows, j):
            return rows[..., j][..., None, None]
    score = torch.full(shape, -np.inf, dtype=f32, device=dev)
    sx = torch.zeros(shape, dtype=f32, device=dev)
    sy = torch.zeros(shape, dtype=f32, device=dev)
    smask = torch.zeros(shape, dtype=torch.int32, device=dev)
    win = torch.full(shape, -1, dtype=torch.int32, device=dev)
    for k in range(n):
        rows = rows_at(k)

        def r(j):
            return col(rows, j)
        l1 = _affine(r(0), gx, r(1), gy, r(2))
        l2 = _affine(r(3), gx, r(4), gy, r(5))
        inside = (l1 >= -_EPS) & (l2 >= -_EPS) & (l1 + l2 <= 1.0 + _EPS)
        take = inside & (r(12) > score)
        score = torch.where(take, r(12), score)
        sx = torch.where(take, _affine(r(6), gx, r(7), gy, r(8)), sx)
        sy = torch.where(take, _affine(r(9), gx, r(10), gy, r(11)), sy)
        win = torch.where(take, row_ids(k), win)
        if geodesic:
            color = r(13).to(torch.int32)
            bit = torch.where(color >= 0,
                              torch.bitwise_left_shift(
                                  torch.ones_like(color), color.clamp(min=0)),
                              0)
            smask = smask | torch.where(inside, bit, 0)
    if cands is not None:
        def asm(a):
            return a.permute(0, 1, 3, 2, 4).reshape(B, h, w)
        score, sx, sy, smask, win = (asm(a) for a in (score, sx, sy, smask,
                                                      win))
    return score, sx, sy, smask, win


def _quant(x, out_kind):
    if out_kind == 'u8':
        return torch.clamp(torch.round(x), 0, 255)
    if out_kind == 'u16':
        return torch.clamp(torch.round(x), 0, 65535)
    return x


def _check_interp(interp):
    if interp not in INTERPS:
        raise ValueError(f'interp must be one of {INTERPS}, got {interp!r}')


def _src_extents(src, B, src_hw):
    if src_hw is not None:
        return [tuple(int(v) for v in hw) for hw in np.asarray(src_hw)]
    return [tuple(src.shape[-2:])] * B


def _lanczos4_plain(s, H, W, xs, ys, fillval):
    """Lanczos-4 samples of the source ``s`` (its real extents (H, W)) at
    (xs, ys), f32 coordinates on the 1/32 px grid, as the kernel spells
    them: taps outside (H, W) read ``fillval``, a window wholly outside
    gives it, every product and sum rounded alone in f32."""
    f32 = torch.float32
    fill = torch.as_tensor(float(fillval), dtype=f32, device=xs.device)
    inside = (xs >= -4) & (xs < W + 3) & (ys >= -4) & (ys < H + 3)
    xq = torch.where(inside, xs, torch.zeros_like(xs))
    yq = torch.where(inside, ys, torch.zeros_like(ys))
    x0 = torch.floor(xq)
    y0 = torch.floor(yq)
    lw = _lanczos4_weights(xs.device)
    wx = lw[((xq - x0) * _FRAC).to(torch.int64)]        # (..., 8)
    wy = lw[((yq - y0) * _FRAC).to(torch.int64)]
    ix = x0.to(torch.int64) - 3
    iy = y0.to(torch.int64) - 3
    val = None
    for r in range(_TAPS):
        yy = iy + r
        row_in = (yy >= 0) & (yy < H)
        yc = yy.clamp(0, H - 1)
        row = None
        for j in range(_TAPS):
            xx = ix + j
            ok = row_in & (xx >= 0) & (xx < W)
            v = torch.where(ok, s[yc, xx.clamp(0, W - 1)], fill)
            t = wx[..., j] * v
            row = t if row is None else row + t
        t = wy[..., r] * row
        val = t if val is None else val + t
    return torch.where(inside, val, fill)


def _finish_plain(src, src_hw, score, sx, sy, smask, fillval, geodesic,
                  out_kind, interp='linear'):
    """Sample the winning coordinates (1/32-px grid) and quantize;
    mirrors _finish_raster up to the mip chain."""
    covered = score != -np.inf
    if geodesic:
        covered = covered & ((smask & (smask - 1)) == 0)   # < 2 bits set
    sxq = torch.round(sx * 32.0) * (1.0 / 32.0)
    syq = torch.round(sy * 32.0) * (1.0 / 32.0)
    shared = src.dim() == 2
    srcf = src.to(torch.float32) if shared else None
    out = torch.empty_like(sx)
    for b, (H, W) in enumerate(src_hw):
        s = srcf if shared else src[b].to(torch.float32)
        if interp == 'lanczos4':
            out[b] = _lanczos4_plain(s, H, W, sxq[b], syq[b], fillval)
        else:
            out[b] = bilinear_sample(s[:H, :W], sxq[b], syq[b],
                                     float(fillval))
    out = torch.where(covered, out, torch.as_tensor(float(fillval),
                                                    device=out.device))
    out = _quant(out, out_kind).to(_OUT_KINDS[out_kind][1])
    return out, covered.flatten(1).any(dim=1)


def _mip_chain(out, out_kind, n_mips, mip_blur):
    """[mip0, mip1, ...]: each level blurs (sigma ``mip_blur``) and 2x
    area-averages the quantized previous level, then quantizes again."""
    levels = [out]
    if not n_mips:
        return levels
    cur = out.to(torch.float32)
    for _ in range(int(n_mips)):
        if mip_blur and mip_blur > 0:
            cur = dog.gaussian_blur(cur.contiguous(), float(mip_blur))
        B, hh, ww = cur.shape
        cur = _quant(cur.reshape(B, hh // 2, 2, ww // 2, 2).mean(dim=(2, 4)),
                     out_kind)
        levels.append(cur.to(_OUT_KINDS[out_kind][1]))
    return levels


def raster_blocks_plain(src, tables, cands, fillval, h, w, geodesic,
                        out_kind, src_hw=None, n_mips=0, mip_blur=0.0,
                        return_state=False, interp='linear'):
    """Plain PyTorch version of ``raster_blocks`` (any device). With
    ``return_state`` also returns the raster state (score, sx, sy, smask,
    winning row), each (B, h, w)."""
    _check_interp(interp)
    state = _raster_state_plain(tables, cands, h, w, geodesic)
    out, cov = _finish_plain(src, _src_extents(src, tables.shape[0], src_hw),
                             *state[:4], fillval, geodesic, out_kind, interp)
    levels = _mip_chain(out, out_kind, n_mips, mip_blur)
    return (levels, cov, state) if return_state else (levels, cov)


# --------------------------------- kernel --------------------------------- #

def corner_keep(rows, corners, affine=_affine):
    """The cull rule of the raster and montage kernels: which triangle rows
    (..., 14) may be inside at some pixel of a rectangle, from its corner
    pixels ``corners`` [(x, y)] (tensors that broadcast against the rows).

    l1 and l2 as ``affine(a, x, b, y, c)`` spells them (each kernel's own
    rounding) are monotone in x and in y (rounding to nearest is
    monotone), so their extremes over the rectangle lie at its corners. A
    row is dropped when its largest l1 or l2 is below -eps, or when its
    smallest l1 plus its smallest l2, which no pixel's rounded l1 + l2
    falls below, exceeds 1 + eps: the per-pixel test then rejects it at
    every pixel of the rectangle."""
    def extremes(j):
        at = torch.stack([affine(rows[..., j], x, rows[..., j + 1], y,
                                 rows[..., j + 2]) for x, y in corners])
        return at.amax(dim=0), at.amin(dim=0)

    hi1, lo1 = extremes(0)
    hi2, lo2 = extremes(3)
    return (hi1 >= -_EPS) & (hi2 >= -_EPS) & (lo1 + lo2 <= 1.0 + _EPS)


def tile_cull_plain(tables, cands, h, w, tile_h):
    """The kernel's tile cull (``corner_keep``), in plain PyTorch: which
    candidate rows survive in each tile of ``_CELL`` x ``tile_h`` px
    (``tile_h`` divides ``_CELL``; tiles are clipped to the block). Returns
    (B, tiles_y, tiles_x, n) bool over the cell's K candidates, or over the
    Tp table rows for a flat table. The raster does not call this; tests
    and the chip check's counts do."""
    B = tables.shape[0]
    dev = tables.device
    nty, ntx = -(-h // tile_h), -(-w // _CELL)
    tx0 = torch.arange(ntx, device=dev) * _CELL
    ty0 = torch.arange(nty, device=dev) * tile_h
    tx1 = torch.clamp(tx0 + _CELL, max=w) - 1
    ty1 = torch.clamp(ty0 + tile_h, max=h) - 1
    if cands is None:
        rows = tables[:, None, None]                     # (B, 1, 1, Tp, 14)
    else:
        cell = ((ty0 // _CELL) * (w // _CELL))[:, None] + tx0[None] // _CELL
        idx = cands.to(torch.int64)[:, cell]             # (B, nty, ntx, K)
        rows = tables[torch.arange(B, device=dev)[:, None, None, None], idx]
    return corner_keep(rows, [(x.to(torch.float32)[None, None, :, None],
                               y.to(torch.float32)[None, :, None, None])
                              for y in (ty0, ty1) for x in (tx0, tx1)])


def _lib():
    """The kernel's library, built and bound at its first launch."""
    if 'mesh_raster' not in _LIBS:
        P, I = ctypes.c_void_p, ctypes.c_int
        _LIBS['mesh_raster'] = build.bind('mesh_raster', {
            # tables, Tp, cands, K, cell, ncx, src, src_bstride, src_stride,
            # src_kind, src_hw, src_h, src_w, fillval, B, h, w, geodesic,
            # out_kind, out, covered, stream
            'mesh_raster': [P, I, P, I, I, I, P, ctypes.c_longlong, I, I, P,
                            I, I, ctypes.c_float, I, I, I, I, I, P, P, P],
            # the same, the Lanczos-4 weights before the stream
            'mesh_raster_lanczos4': [P, I, P, I, I, I, P, ctypes.c_longlong,
                                     I, I, P, I, I, ctypes.c_float, I, I, I,
                                     I, I, P, P, P, P],
            'mesh_raster_tile_h': []})
    return _LIBS['mesh_raster']


def kernel_tile_h():
    """Tile height in px of the built kernel (its tiles are
    ``_CELL`` px wide), as ``tile_cull_plain`` takes it."""
    return int(_lib().mesh_raster_tile_h())


def _prepare(src, tables, cands, fillval, h, w, geodesic, out_kind, src_hw,
             interp='linear'):
    """Check one batch for the kernel. Returns (run, B, out dtype):
    ``run(out, covered)`` enqueues one launch on the current stream into a
    (B, h, w) tensor of that dtype and a (B,) bool tensor, and counts it
    (``launch.mesh_raster``, or ``launch.mesh_raster_lanczos4``)."""
    _check_interp(interp)
    dev = tables.device
    if tables.dtype != torch.float32 or tables.dim() != 3 \
            or tables.shape[-1] != 14 or not tables.is_contiguous() \
            or tables.data_ptr() % 8:
        raise ValueError('tables must be a contiguous, 8-byte aligned '
                         '(B, Tp, 14) float32 tensor, got '
                         f'{tuple(tables.shape)} {tables.dtype}')
    B, Tp = tables.shape[:2]
    if src.device != dev:
        raise ValueError(f'source on {src.device}, tables on {dev}')
    if src.dtype not in (torch.uint8, torch.float32):
        src = src.to(torch.float32)
    src = src.contiguous()
    per_block = src.dim() == 3
    if per_block and src.shape[0] != B:
        raise ValueError(f'{src.shape[0]} source crops for {B} blocks')
    Hs, Ws = src.shape[-2:]
    hw_t = None
    if src_hw is not None:
        # per-block extents: one (B, 2) int32 tensor on the card
        hw = _src_extents(src, B, src_hw)
        if len(hw) != B or any(H < 2 or W < 2 or H > Hs or W > Ws
                               for H, W in hw):
            raise ValueError(f'source extents {hw} outside the ({Hs}, {Ws}) '
                             f'source of {B} blocks')
        hw_t = torch.as_tensor(np.asarray(hw, np.int32).reshape(B, 2),
                               device=dev)
    elif Hs < 2 or Ws < 2:
        raise ValueError(f'source ({Hs}, {Ws}) smaller than 2 x 2')
    K, ncx, cand_ptr = Tp, 1, None
    if cands is not None:
        if h % _CELL or w % _CELL:
            raise ValueError(f'cells need block dims divisible by {_CELL}')
        ncx = w // _CELL
        if (cands.dtype != torch.int32 or cands.device != dev
                or tuple(cands.shape[:2]) != (B, (h // _CELL) * ncx)):
            raise ValueError('cands must be (B, cells, K) int32 on the '
                             f'tables\' device, got {tuple(cands.shape)}')
        cands = cands.contiguous()
        K, cand_ptr = cands.shape[2], cands.data_ptr()
    code, dt = _OUT_KINDS[out_kind]
    lib = _lib()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    args = (tables.data_ptr(), Tp, cand_ptr, K, _CELL, ncx, src.data_ptr(),
            Hs * Ws if per_block else 0, Ws,
            0 if src.dtype == torch.uint8 else 1,
            None if hw_t is None else hw_t.data_ptr(), Hs, Ws,
            float(fillval), B, h, w, int(bool(geodesic)), code)
    kernel, fn, after = 'mesh_raster', lib.mesh_raster, ()
    weights = None
    if interp == 'lanczos4':
        weights = _lanczos4_weights(dev)
        kernel, fn = 'mesh_raster_lanczos4', lib.mesh_raster_lanczos4
        after = (weights.data_ptr(),)

    def run(out, covered):
        if (out.dtype != dt or tuple(out.shape) != (B, h, w)
                or covered.dtype != torch.bool or covered.numel() != B
                or out.device != dev or covered.device != dev
                or not out.is_contiguous()):
            raise ValueError('outputs must be a contiguous (B, h, w) '
                             f'{dt} tensor and a (B,) bool tensor on {dev}')
        err = device_mod.launch_on(index, fn, *args, out.data_ptr(),
                                   covered.data_ptr(), *after)
        if err != 0:
            raise RuntimeError(f'{kernel} launch failed: CUDA error {err}')
        device_mod.count_launch(kernel, (B, h, w))

    # alive as long as ``run`` is
    run.tensors = (src, tables, cands, hw_t, weights)
    return run, B, dt


def _launch(src, tables, cands, fillval, h, w, geodesic, out_kind, src_hw,
            interp='linear'):
    run, B, dt = _prepare(src, tables, cands, fillval, h, w, geodesic,
                          out_kind, src_hw, interp)
    out = torch.empty((B, h, w), dtype=dt, device=tables.device)
    covered = torch.empty(B, dtype=torch.bool, device=tables.device)
    run(out, covered)
    return out, covered


def raster_blocks(src, tables, cands, fillval, h, w, geodesic, out_kind,
                  src_hw=None, n_mips=0, mip_blur=0.0, interp='linear'):
    """Rasterize + warp a batch of B output blocks of (h, w) px.

    src: (Hs, Ws) source shared by every block, or (B, Hs, Ws) per-block
        crops (uint8 or float32; other dtypes are widened to float32);
        ``src_hw`` (B, 2) gives each block's real source extents (default:
        the whole array).
    tables: (B, Tp, 14) float32 coefficient rows (see module docstring);
        padding rows have l1c < -1 and weight -inf.
    cands: (B, (h/128)*(w/128), K) int32 candidate rows per 128-px cell,
        ascending (padding entries point at an inert row), or None for the
        flat loop over every row.
    interp: 'linear' (bilinear) or 'lanczos4' (see the module docstring).
    Returns ([mip0 (B, h, w), mip1 (B, h/2, w/2), ...] in the output dtype
    of ``out_kind`` ('u8' | 'u16' | 'f32'), covered (B,) bool).
    """
    if tables.device.type == 'cpu':
        return raster_blocks_plain(src, tables, cands, fillval, h, w,
                                   geodesic, out_kind, src_hw, n_mips,
                                   mip_blur, interp=interp)
    out, cov = _launch(src, tables, cands, fillval, h, w, geodesic,
                       out_kind, src_hw, interp)
    return _mip_chain(out, out_kind, n_mips, mip_blur), cov


# ------------------------------ render engine ------------------------------ #

class DeviceRenderEngine:
    """Per-mesh device render engine (built lazily by the port's
    ``renderer.MeshRenderer``).

    Holds f64 global-frame per-triangle data; ``render_blocks`` selects
    each block's candidate triangles, builds its block-local table (and
    cell candidates for dense blocks), batches same-shape blocks and
    launches one raster per batch as soon as it fills.
    """

    def __init__(self, mesh, target_gear, source_gear, tri_weights,
                 colors=None, device=None):
        self.device = device_mod.get_device(device)
        vw = np.asarray(mesh.vertices_w_offset(target_gear), np.float64)
        tris = mesh.triangles
        self._P = vw[tris]                                # (T, 3, 2) target
        vs = np.asarray(mesh.vertices_w_offset(source_gear), np.float64)
        self._Psrc = vs[tris]                             # (T, 3, 2) source
        self._tb = np.concatenate(
            [self._P.min(axis=1), self._P.max(axis=1)], axis=1)  # x0 y0 x1 y1
        A, b = mesh.triangle_affine_tform(gear0=target_gear,
                                          gear1=source_gear)
        self._A = np.asarray(A, np.float64)
        self._b = np.asarray(b, np.float64)
        a = self._P[:, 0]
        e1 = self._P[:, 1] - a
        e2 = self._P[:, 2] - a
        den = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        ok = np.abs(den) > 1e-12
        safe = np.where(ok, den, 1.0)
        # l1/l2 as affine functions of world position (c_x, c_y, c_0)
        self._l1 = np.stack([e2[:, 1] / safe, -e2[:, 0] / safe], -1)
        self._l2 = np.stack([-e1[:, 1] / safe, e1[:, 0] / safe], -1)
        self._l1c = -(a * self._l1).sum(-1)
        self._l2c = -(a * self._l2).sum(-1)
        w = np.asarray(tri_weights, np.float64).copy()
        w[~ok] = -np.inf                                  # degenerate: never
        self._w = w
        self._colors = (np.full(len(tris), -1, np.float64) if colors is None
                        else np.asarray(colors, np.float64))
        self._geodesic = colors is not None
        self._whole_src = None       # (tensor, (x0, y0)) when resident
        self._whole_src_failed = False

    def _table_for_block(self, sel, origin, src_origin, wts):
        """(Tp, 14) f32 block-local coefficient table for triangles sel."""
        ox, oy = origin
        sx0, sy0 = src_origin
        n = sel.size
        # +1: at least one inert row always follows the real rows, so cell
        # candidate tables can use row n as the padding sentinel
        Tp = _align_up(n + 1, _CHUNK, _CHUNK)
        tab = np.zeros((Tp, 14), np.float32)
        tab[:, 2] = -2.0               # padding rows: l1 < 0 -> never inside
        tab[:, 12] = -np.inf
        tab[:, 13] = -1.0
        if n:
            l1 = self._l1[sel]
            l2 = self._l2[sel]
            A = self._A[sel]
            b = self._b[sel]
            tab[:n, 0:2] = l1
            tab[:n, 2] = self._l1c[sel] + l1[:, 0] * ox + l1[:, 1] * oy
            tab[:n, 3:5] = l2
            tab[:n, 5] = self._l2c[sel] + l2[:, 0] * ox + l2[:, 1] * oy
            tab[:n, 6] = A[:, 0, 0]
            tab[:n, 7] = A[:, 1, 0]
            tab[:n, 8] = b[:, 0] + ox * A[:, 0, 0] + oy * A[:, 1, 0] - sx0
            tab[:n, 9] = A[:, 0, 1]
            tab[:n, 10] = A[:, 1, 1]
            tab[:n, 11] = b[:, 1] + ox * A[:, 0, 1] + oy * A[:, 1, 1] - sy0
            tab[:n, 12] = wts[sel]
            tab[:n, 13] = self._colors[sel]
        return tab

    def _cells_for_block(self, sel, origin, hp, wp):
        """(NC, Kp) int32 candidate rows (local indices into this block's
        table) of each ``_CELL``-px cell the triangles' bboxes touch,
        ascending within each cell; padding entries point at row
        ``sel.size`` (inert by the +1 pad of ``_table_for_block``)."""
        C = _CELL
        ncy, ncx = hp // C, wp // C
        NC = ncy * ncx
        n = sel.size
        ox, oy = origin
        tb = self._tb[sel]
        bx0 = np.clip(np.floor((tb[:, 0] - ox) / C).astype(np.int64), 0, ncx - 1)
        by0 = np.clip(np.floor((tb[:, 1] - oy) / C).astype(np.int64), 0, ncy - 1)
        bx1 = np.clip(np.floor((tb[:, 2] - ox) / C).astype(np.int64), 0, ncx - 1)
        by1 = np.clip(np.floor((tb[:, 3] - oy) / C).astype(np.int64), 0, ncy - 1)
        spanx = bx1 - bx0 + 1
        spany = by1 - by0 + 1
        cells = []
        tris = []
        all_tri = np.arange(n, dtype=np.int64)
        for dy in range(int(spany.max())):
            my = dy < spany
            for dx in range(int(spanx.max())):
                m = my & (dx < spanx)
                if not m.any():
                    continue
                cells.append((by0[m] + dy) * ncx + (bx0[m] + dx))
                tris.append(all_tri[m])
        cell_ids = np.concatenate(cells)
        tri_ids = np.concatenate(tris)
        order = np.lexsort((tri_ids, cell_ids))
        cell_sorted = cell_ids[order]
        starts = np.searchsorted(cell_sorted, np.arange(NC))
        pos = np.arange(len(order)) - starts[cell_sorted]
        K = int(pos.max()) + 1
        Kp = max(4, 1 << (K - 1).bit_length())
        cand = np.full((NC, Kp), n, np.int32)
        cand[cell_sorted, pos] = tri_ids[order]
        return cand

    def _table_affine(self, A, b, origin, src_origin):
        """Single-row table: one always-inside 'triangle' carrying an
        affine that covers the whole block (the renderer's affine
        short-circuit)."""
        ox, oy = origin
        sx0, sy0 = src_origin
        tab = np.zeros((_CHUNK, 14), np.float32)
        tab[:, 2] = -2.0
        tab[:, 12] = -np.inf
        tab[:, 13] = -1.0
        # l1 = l2 = 0.25 everywhere: inside for every pixel
        tab[0, 0:6] = [0.0, 0.0, 0.25, 0.0, 0.0, 0.25]
        tab[0, 6] = A[0, 0]
        tab[0, 7] = A[1, 0]
        tab[0, 8] = b[0] + ox * A[0, 0] + oy * A[1, 0] - sx0
        tab[0, 9] = A[0, 1]
        tab[0, 10] = A[1, 1]
        tab[0, 11] = b[1] + ox * A[0, 1] + oy * A[1, 1] - sy0
        tab[0, 12] = 1.0
        return tab

    def source_can_reside(self, loader):
        """Can this loader's whole source stay on the device, so per-block
        work ships only the coefficient table?"""
        img = getattr(loader, '_img', None)
        if img is None or not hasattr(loader, 'bbox') or img.ndim != 2:
            return False
        itemsize = np.dtype(getattr(loader, 'dtype', None)
                            or img.dtype).itemsize
        return img.size * itemsize <= WHOLE_SRC_CAP

    def _resident_source(self, loader, fillval):
        """Upload a whole-section source once and reuse it for every block:
        2 px of fill all around (the host path's BORDER_CONSTANT blend at
        the image edge), bucket-aligned to ``_SRC_ALIGN``."""
        if self._whole_src is not None:
            return self._whole_src
        if self._whole_src_failed:
            return None
        if not self.source_can_reside(loader):
            self._whole_src_failed = True
            return None
        img = loader._img
        x0, y0 = loader.bbox[:2]
        pad = 2
        H = _align_up(img.shape[0] + 2 * pad, _SRC_ALIGN, _SRC_ALIGN)
        W = _align_up(img.shape[1] + 2 * pad, _SRC_ALIGN, _SRC_ALIGN)
        data = loader.preprocess(img) if hasattr(loader, 'preprocess') else img
        # the canvas dtype follows the loader's declared dtype, as the host
        # path pastes preprocessed data into a loader.dtype canvas
        dt = np.dtype(getattr(loader, 'dtype', None) or data.dtype)
        buf = np.full((H, W), fillval, dt)
        buf[pad:pad + img.shape[0], pad:pad + img.shape[1]] = data
        self._whole_src = (torch.from_numpy(buf).to(self.device),
                           (x0 - pad, y0 - pad))
        return self._whole_src

    def render_blocks(self, blocks, loader, fillval, out_dtype,
                      wts=None, shortcircuit=None, emit_mips=0,
                      mip_blur=0.0, interp='linear', **crop_kwargs):
        """Render output blocks [(x0, y0, x1, y1)] through the mesh,
        sampling the source by ``interp`` (``INTERPS``).

        Returns [(array | None)] aligned with ``blocks``; None when the
        block has no mesh coverage. With ``emit_mips`` = k each covered
        result is a tuple (mip0, ..., mipk); blocks whose dims do not
        divide 2**k (or that pad) return mip0 only and the caller finishes
        the chain.
        """
        _check_interp(interp)
        out_kind = _out_kind(out_dtype)
        if wts is None:
            wts = self._w
        resident = None
        from feabas_tpu_torch.dal import StreamLoader
        if isinstance(loader, StreamLoader):
            resident = self._resident_source(loader, fillval)
        prepared = {}     # block index -> (h, w, group_key, tab, src, cand)
        results = [None] * len(blocks)
        pending = {}               # group_key -> [block index]
        launched = []              # (idxs, key, levels, covered)

        def dispatch(key, idxs):
            hp, wp, nm = key[0], key[1], key[2]
            Tp = max(prepared[i][3].shape[0] for i in idxs)
            Tp = _align_up(1 << int(Tp - 1).bit_length(), _CHUNK, _CHUNK)
            with trace.span('render.tables'):
                tabs = np.zeros((len(idxs), Tp, 14), np.float32)
                tabs[:, :, 2] = -2.0
                tabs[:, :, 12] = -np.inf
                tabs[:, :, 13] = -1.0
                for k, i in enumerate(idxs):
                    t = prepared[i][3]
                    tabs[k, :t.shape[0]] = t
                cands = None
                if key[-1] == 'cells':
                    # padding entries point at row Tp-1, inert for every
                    # block
                    Kp = max(prepared[i][5].shape[-1] for i in idxs)
                    NC = prepared[idxs[0]][5].shape[0]
                    cands = np.full((len(idxs), NC, Kp), Tp - 1, np.int32)
                    for k, i in enumerate(idxs):
                        c = prepared[i][5]
                        cands[k, :, :c.shape[-1]] = c
            src, tabs, cands = state.render_batch_to_device(
                None if key[3] == 'resident'
                else [prepared[i][4] for i in idxs],
                tabs, cands, self.device)
            if src is None:
                src = resident[0]
            levels, cov = raster_blocks(
                src, tabs, cands, float(fillval), hp, wp, self._geodesic,
                out_kind, n_mips=nm, mip_blur=mip_blur, interp=interp)
            launched.append((idxs, key, levels, cov))

        def consume(entry):
            idxs, key, levels, cov = entry
            cov = cov.cpu().numpy()
            levels = [lv.cpu().numpy() for lv in levels]
            for k, i in enumerate(idxs):
                if not cov[k]:
                    continue
                h, w = prepared[i][0], prepared[i][1]
                mips = []
                for lvl, arr in enumerate(levels):
                    blk = arr[k, :h >> lvl, :w >> lvl]
                    if (out_kind == 'f32'
                            and np.dtype(out_dtype) != np.float32):
                        blk = blk.astype(out_dtype)
                    mips.append(blk)
                results[i] = tuple(mips) if emit_mips else mips[0]

        self._render_prepare_dispatch(
            blocks, loader, fillval, out_kind, wts, shortcircuit,
            resident, prepared, pending, dispatch, crop_kwargs, emit_mips,
            interp)
        for key, idxs in pending.items():
            dispatch(key, idxs)
        for entry in launched:
            consume(entry)
        return results

    def _render_prepare_dispatch(self, blocks, loader, fillval, out_kind,
                                 wts, shortcircuit, resident, prepared,
                                 pending, dispatch, crop_kwargs,
                                 emit_mips=0, interp='linear'):
        """Host prep: per-block candidate selection, coefficient table,
        source crop (reaching ``_SRC_HALO[interp]`` px past the block's
        source coordinates); groups dispatch as soon as they fill."""
        halo = _SRC_HALO[interp]
        on_card = self.device.type == 'cuda'
        for i, bbox in enumerate(blocks):
            x0 = int(np.floor(bbox[0]))
            y0 = int(np.floor(bbox[1]))
            x1 = int(np.ceil(bbox[2]))
            y1 = int(np.ceil(bbox[3]))
            h, w = y1 - y0, x1 - x0
            if h <= 0 or w <= 0:
                continue
            sc = shortcircuit((x0, y0, x1, y1)) if shortcircuit else None
            if sc is None:
                with trace.span('render.tables'):
                    tb = self._tb
                    sel = np.nonzero((tb[:, 0] < x1) & (tb[:, 2] > x0) &
                                     (tb[:, 1] < y1) & (tb[:, 3] > y0) &
                                     np.isfinite(wts))[0]
                if sel.size == 0:
                    continue
            hp = _align_up(h, _OUT_ALIGN, min(_OUT_ALIGN, 64))
            wp = _align_up(w, _OUT_ALIGN, min(_OUT_ALIGN, 64))
            # fused mips only for unpadded, 2**k-divisible blocks (padding
            # would let the pre-blur bleed fill into the real region)
            nm = emit_mips if (emit_mips and hp == h and wp == w
                               and h % (1 << emit_mips) == 0
                               and w % (1 << emit_mips) == 0) else 0
            if resident is not None:
                src_origin = resident[1]
                src = None
                key = (hp, wp, nm, 'resident')
            else:
                if sc is not None:
                    # source extent = affine image of the block corners
                    A, b = sc
                    cn = np.array([[x0, y0], [x1, y0], [x0, y1], [x1, y1]],
                                  np.float64)
                    ps = cn @ np.asarray(A) + np.asarray(b)
                else:
                    ps = self._Psrc[sel].reshape(-1, 2)
                sx0 = int(np.floor(ps[:, 0].min())) - halo
                sy0 = int(np.floor(ps[:, 1].min())) - halo
                sx1 = int(np.ceil(ps[:, 0].max())) + halo
                sy1 = int(np.ceil(ps[:, 1].max())) + halo
                sw = _align_up(sx1 - sx0, _SRC_ALIGN, _SRC_ALIGN)
                sh = _align_up(sy1 - sy0, _SRC_ALIGN, _SRC_ALIGN)
                src = loader.crop((sx0, sy0, sx0 + sw, sy0 + sh),
                                  return_empty=True, **crop_kwargs)
                if src is None:
                    src = np.full((_SRC_ALIGN, _SRC_ALIGN), fillval,
                                  np.uint8 if out_kind == 'u8' else
                                  np.float32)
                src = np.ascontiguousarray(src)
                key = (hp, wp, nm, src.shape, src.dtype.name)
                src_origin = (sx0, sy0)
            cand = None
            with trace.span('render.tables'):
                if sc is not None:
                    tab = self._table_affine(sc[0], sc[1], (x0, y0),
                                             src_origin)
                else:
                    tab = self._table_for_block(sel, (x0, y0), src_origin,
                                                wts)
                    if sel.size > _CELL_MIN_TRIS:
                        cand = self._cells_for_block(sel, (x0, y0), hp, wp)
            key = key + (('cells',) if cand is not None else ('flat',))
            prepared[i] = (h, w, key, tab, src, cand)
            trace.count('render.blocks')
            if on_card:
                trace.count('render.device_blocks')
            if interp == 'lanczos4':
                trace.count('render.lanczos_px', h * w)
            grp = pending.setdefault(key, [])
            grp.append(i)
            if len(grp) >= _group_cap(key[0] * key[1]):
                dispatch(key, pending.pop(key))
