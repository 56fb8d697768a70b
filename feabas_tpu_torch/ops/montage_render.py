"""Montage blending on the device: every tile hitting an output block is
rasterized, sampled and blended (LINEAR, or two-band PYRAMID) in one pass
over the block's cells (counterpart of ``feabas_tpu/ops/montage_render.py``).

The output block splits into CELL-px cells; each cell carries a padded
list of the tiles whose bounds touch it (host table). Per candidate tile:
rasterize its triangle table on the cell grid, evaluate tile-local source
coordinates, take one packed-quad bilinear sample per pixel, apply the
tile's gain/offset and the distance-to-tile-border blend weight. LINEAR
accumulates sum(w*val)/sum(w); PYRAMID blends a low band (a
mask-normalized blur of each tile, ``pack_low_stack``) linearly and takes
the high band from the dominant tile.

``montage_blend`` is the hand-written kernel ``csrc/montage_blend.cu`` on a
CUDA tensor and its plain PyTorch version, ``montage_blend_plain``, on a CPU
tensor. The JAX package sends a block with more than 128 triangle rows per
tile to the host path, because its TPU program unrolls the raster loop;
here the kernel streams any number of rows, so that cap is dropped.
"""

import ctypes

import numpy as np
import torch

from feabas_tpu_torch import build
from feabas_tpu_torch import constant as const
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch.ops.filters import gaussian_blur
from feabas_tpu_torch.ops.render import corner_keep
from feabas_tpu_torch.ops.warp import bilinear_sample_packed, pack_u8_quads

CELL = 64
# blocks where one cell touches more tiles take the host path
K_CAP = 64
# whole-section packed stacks up to this many bytes stay device-resident
RESIDENT_STACK_CAP = 4 * 1024 ** 3
RESIDENT_STACK_MIN_TILES = 64
_EPS = 1e-9
_OUT_KINDS = {'u8': 0, 'f32': 1}
_LIBS = {}


# ------------------------------ plain version ------------------------------ #

def _raster_plain(tab, px, py, rows=None):
    """(score, sx, sy) of one candidate tile per cell: ``tab`` (C, R, 14)
    its table rows, px (C, 1, CELL) and py (C, CELL, 1) the cells' pixel
    coordinates, ``rows`` (C, R) bool the rows each cell may use (all
    where None). Every product and sum is its own f32 op."""
    C, R = tab.shape[:2]
    shape = (C, CELL, CELL)
    score = torch.full(shape, -torch.inf, dtype=torch.float32,
                       device=tab.device)
    sx = torch.zeros(shape, dtype=torch.float32, device=tab.device)
    sy = sx
    for j in range(R):
        row = tab[:, j, :, None, None]            # (C, 14, 1, 1)
        l1 = row[:, 0] * px + row[:, 1] * py + row[:, 2]
        l2 = row[:, 3] * px + row[:, 4] * py + row[:, 5]
        inside = (l1 >= -_EPS) & (l2 >= -_EPS) & (l1 + l2 <= 1.0 + _EPS)
        if rows is not None:
            inside = inside & rows[:, j, None, None]
        take = inside & (row[:, 12] > score)
        score = torch.where(take, row[:, 12], score)
        sx = torch.where(take, row[:, 6] * px + row[:, 7] * py + row[:, 8], sx)
        sy = torch.where(take, row[:, 9] * px + row[:, 10] * py + row[:, 11], sy)
    return score, sx, sy


def winner_rows_plain(tab, px, py, rows=None):
    """The kernel's raster of one candidate tile per cell, in plain PyTorch
    (``_raster_plain``'s arguments): (row, weight), each (C, CELL, CELL),
    the table row each pixel takes (the first inside row of the largest
    weight, whose affine ``_raster_plain`` evaluates) and its weight; -1
    and -inf where no row covers the pixel. The kernel's blend recomputes
    (sx, sy) from that row's affine with ``_raster_plain``'s rounded ops."""
    C, R = tab.shape[:2]
    shape = (C, CELL, CELL)
    weight = torch.full(shape, -torch.inf, dtype=torch.float32,
                        device=tab.device)
    win = torch.full(shape, -1, dtype=torch.int64, device=tab.device)
    for j in range(R):
        row = tab[:, j, :, None, None]            # (C, 14, 1, 1)
        l1 = row[:, 0] * px + row[:, 1] * py + row[:, 2]
        l2 = row[:, 3] * px + row[:, 4] * py + row[:, 5]
        inside = (l1 >= -_EPS) & (l2 >= -_EPS) & (l1 + l2 <= 1.0 + _EPS)
        if rows is not None:
            inside = inside & rows[:, j, None, None]
        take = inside & (row[:, 12] > weight)
        weight = torch.where(take, row[:, 12], weight)
        win = torch.where(take, j, win)
    return win, weight


def _affine_plain(a, x, b, y, c):
    """a * x + b * y + c as ``_raster_plain`` rounds it: three f32 ops."""
    return a * x + b * y + c


def _cell_grid(cell_ids, ncx, dev):
    """px (C, 1, CELL) and py (C, CELL, 1) of cells ``cell_ids``."""
    ar = torch.arange(CELL, dtype=torch.float32, device=dev)
    cy = (cell_ids // ncx) * CELL
    cx = (cell_ids % ncx) * CELL
    return (cx.to(torch.float32)[:, None, None] + ar[None, None, :],
            cy.to(torch.float32)[:, None, None] + ar[None, :, None])


def montage_blend_plain(srcs, lows, gmap, tables, aux, cands, fillval, ncy,
                        ncx, out_kind='u8', pyramid=False, rows=None):
    """Plain PyTorch version of ``montage_blend`` (any device). ``rows``
    (ncy*ncx, K, R) bool, where given, limits each cell's candidates to
    those table rows (``cell_cull_plain``)."""
    dev = tables.device
    # only cells with a candidate tile do work; the rest stay fillval
    cell_ids = torch.nonzero((cands >= 0).any(dim=1)).reshape(-1)
    cands = cands[cell_ids]
    if rows is not None:
        rows = rows[cell_ids]
    C, K = cands.shape
    px, py = _cell_grid(cell_ids, ncx, dev)
    zero = torch.zeros((C, CELL, CELL), dtype=torch.float32, device=dev)
    acc, wacc, best_w, best_hi = zero, zero, zero, zero
    for k in range(K):
        idx = cands[:, k]
        live = idx >= 0
        i = torch.clamp(idx, min=0)
        a = aux[i][:, :, None, None]                  # (C, 5, 1, 1)
        score, sx, sy = _raster_plain(tables[i], px, py,
                                      None if rows is None else rows[:, k])
        covered = (score != -torch.inf) & live[:, None, None]
        # cv2 INTER_LINEAR's 1/32-px fixed-point grid (host parity)
        sxq = torch.round(sx * 32.0) * (1.0 / 32.0)
        syq = torch.round(sy * 32.0) * (1.0 / 32.0)
        slot = gmap[i]
        val = bilinear_sample_packed(srcs, sxq, syq, slot=slot) * a[:, 3] + a[:, 4]
        # blend weight: distance to the source-tile border (tile pixels)
        d = torch.minimum(torch.minimum(sx, a[:, 0] - sx),
                          torch.minimum(sy, a[:, 1] - sy))
        w = torch.where(covered, torch.clamp(d / a[:, 2], 0.0, 1.0), 0.0)
        if pyramid:
            lowv = bilinear_sample_packed(lows, sxq, syq, slot=slot) * a[:, 3] + a[:, 4]
            # strict >: the first tile in hits order wins ties, and zero-
            # weight border pixels never become the dominant tile
            upd = w > best_w
            best_w = torch.where(upd, w, best_w)
            best_hi = torch.where(upd, val - lowv, best_hi)
            acc = acc + lowv * w
        else:
            acc = acc + val * w
        wacc = wacc + w
    blended = acc / torch.clamp(wacc, min=1e-20) + best_hi
    out = torch.full((ncy * ncx, CELL, CELL), float(fillval),
                     dtype=torch.float32, device=dev)
    out[cell_ids] = torch.where(wacc > 0, blended, float(fillval))
    covered_any = bool((wacc > 0).any())
    out = out.reshape(ncy, ncx, CELL, CELL).permute(0, 2, 1, 3) \
        .reshape(ncy * CELL, ncx * CELL)
    if out_kind == 'u8':
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out, covered_any


def cell_cull_plain(tables, cands, ncx):
    """The kernel's per-cell row cull, in plain PyTorch: (C, K, R) bool,
    which table rows of each cell's candidate tiles survive (none of a -1
    candidate). A row goes where the raster's corner rule
    (``render.corner_keep``, on l1 and l2 as ``_raster_plain`` spells them:
    three rounded f32 ops) puts it inside at no pixel of the cell, or where
    its weight is -inf (it never wins). A dropped row changes no pixel. The
    blend does not call this; tests and the chip check's counts do."""
    C, K = cands.shape
    dev = tables.device
    cell = torch.arange(C, device=dev)
    xs = ((cell % ncx) * CELL).to(torch.float32)[:, None]
    ys = ((cell // ncx) * CELL).to(torch.float32)[:, None]
    corners = [(x, y) for y in (ys, ys + (CELL - 1)) for x in (xs, xs + (CELL - 1))]
    keep = torch.zeros((C, K, tables.shape[1]), dtype=torch.bool, device=dev)
    for k in range(K):
        idx = cands[:, k]
        tab = tables[torch.clamp(idx, min=0)]          # (C, R, 14)
        keep[:, k] = ((idx >= 0)[:, None] & (tab[..., 12] > -torch.inf)
                      & corner_keep(tab, corners, _affine_plain))
    return keep


def covered_pixels_plain(tables, cands, ncx):
    """(pixel, candidate) pairs of a block that some table row covers: the
    samples its blend needs. Tests and the chip check's bound count them."""
    live = torch.nonzero((cands >= 0).any(dim=1)).reshape(-1)
    px, py = _cell_grid(live, ncx, tables.device)
    n = 0
    for k in range(cands.shape[1]):
        idx = cands[live, k]
        score, _, _ = _raster_plain(tables[torch.clamp(idx, min=0)], px, py)
        n += int(((score != -torch.inf) & (idx >= 0)[:, None, None]).sum())
    return n


# --------------------------------- kernel --------------------------------- #

def _lib():
    """The kernel's library, built and bound at its first launch."""
    if 'montage_blend' not in _LIBS:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib = build.bind('montage_blend', {
            # srcs, lows, H, W, gmap, tables, R, aux, cands, K, ncy, ncx,
            # fillval, pyramid, out_kind, out, covered, stream
            'montage_blend': [P, P, I, I, P, P, I, P, P, I, I, I,
                              ctypes.c_float, I, I, P, P, P],
            'montage_blend_cell': [],
            'montage_blend_attrs': [I, I, P]})
        if lib.montage_blend_cell() != CELL:
            raise RuntimeError(f'csrc/montage_blend.cu kCell != {CELL}')
        _LIBS['montage_blend'] = lib
    return _LIBS['montage_blend']


def kernel_attrs(pyramid, out_kind='u8'):
    """What the card's runtime reports for one instantiation of the
    kernel: {'registers', 'local_bytes' (spills), 'shared_bytes',
    'blocks_per_sm'} (256-thread blocks resident on one SM)."""
    out = (ctypes.c_int * 4)()
    err = _lib().montage_blend_attrs(int(bool(pyramid)), _OUT_KINDS[out_kind],
                                     out)
    if err != 0:
        raise RuntimeError(f'montage_blend_attrs failed: CUDA error {err}')
    return dict(zip(('registers', 'local_bytes', 'shared_bytes',
                     'blocks_per_sm'), out))


def _need(t, name, dtype, shape, dev):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != dev):
        raise ValueError(f'{name} must be a contiguous {tuple(shape)} {dtype} '
                         f'tensor on {dev}, got {tuple(t.shape)} {t.dtype} '
                         f'on {t.device}')


def _prepare(srcs, lows, gmap, tables, aux, cands, fillval, ncy, ncx,
             out_kind='u8', pyramid=False):
    """Check one block for the kernel. Returns (run, out shape, out dtype):
    ``run(out, covered)`` enqueues one launch on the current stream into an
    (ncy*CELL, ncx*CELL) tensor of that dtype and a (1,) bool tensor, and
    counts it."""
    dev = tables.device
    if tables.dim() != 3 or srcs.dim() != 3 or cands.dim() != 2:
        raise ValueError('expected tables (T, R, 14), srcs (N, H, W) and '
                         f'cands (C, K), got {tuple(tables.shape)}, '
                         f'{tuple(srcs.shape)}, {tuple(cands.shape)}')
    T, R = tables.shape[:2]
    N, H, W = srcs.shape
    C, K = cands.shape
    _need(tables, 'tables', torch.float32, (T, R, 14), dev)
    _need(srcs, 'srcs', torch.int32, (N, H, W), dev)
    if pyramid:
        _need(lows, 'lows', torch.int32, (N, H, W), dev)
    _need(gmap, 'gmap', torch.int64, (T,), dev)
    _need(aux, 'aux', torch.float32, (T, 5), dev)
    _need(cands, 'cands', torch.int64, (ncy * ncx, K), dev)
    if out_kind not in _OUT_KINDS:
        raise ValueError(f'out_kind {out_kind!r} not in {list(_OUT_KINDS)}')
    if H < 2 or W < 2 or tables.data_ptr() % 8:
        raise ValueError(f'sources ({H}, {W}) smaller than 2 x 2, or tables '
                         'not 8-byte aligned')
    # the kernel reads table rows and stack planes at these indices as
    # they are: one reduction and one read for both
    lims = torch.stack([
        *(torch.aminmax(cands) if cands.numel() else cands.new_tensor([-1, -1])),
        *(torch.aminmax(gmap) if gmap.numel() else gmap.new_tensor([0, 0]))])
    c_lo, c_hi, g_lo, g_hi = lims.tolist()
    if c_lo < -1 or c_hi >= T or g_lo < 0 or g_hi >= N:
        raise ValueError(f'cands in [{c_lo}, {c_hi}] outside [-1, {T}) or '
                         f'gmap in [{g_lo}, {g_hi}] outside [0, {N})')
    if dev.type != 'cuda':
        raise ValueError(f'the montage_blend kernel needs CUDA tensors, got '
                         f'{dev}')
    lib = _lib()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    shape = (ncy * CELL, ncx * CELL)
    dt = torch.uint8 if out_kind == 'u8' else torch.float32
    args = (srcs.data_ptr(), lows.data_ptr() if pyramid else None, H, W,
            gmap.data_ptr(), tables.data_ptr(), R, aux.data_ptr(),
            cands.data_ptr(), K, ncy, ncx, float(fillval), int(bool(pyramid)),
            _OUT_KINDS[out_kind])

    def run(out, covered):
        if (out.dtype != dt or tuple(out.shape) != shape
                or covered.dtype != torch.bool or covered.numel() != 1
                or out.device != dev or covered.device != dev
                or not out.is_contiguous()):
            raise ValueError(f'outputs must be a contiguous {shape} {dt} '
                             f'tensor and a (1,) bool tensor on {dev}')
        err = device_mod.launch_on(index, lib.montage_blend, *args,
                                   out.data_ptr(), covered.data_ptr())
        if err != 0:
            raise RuntimeError(f'montage_blend launch failed: CUDA error {err}')
        device_mod.count_launch('montage_blend', (C, K, R))

    run.tensors = (srcs, lows, gmap, tables, aux, cands)   # alive with run
    return run, shape, dt


def montage_blend(srcs, lows, gmap, tables, aux, cands, fillval, ncy, ncx,
                  out_kind='u8', pyramid=False):
    """Blend one output block from per-tile tables + sources.

    Args:
        srcs: (N, Hs, Ws) int32 packed-quad tile images (pack_tile_stack).
        lows: the PYRAMID low-band stack (``pack_low_stack``); ``srcs``
            when pyramid is False (unused).
        gmap: (T,) int64 block-local tile slot -> row of ``srcs``.
        tables: (T, R, 14) f32 per-tile triangle tables in block-local
            coordinates, source in TILE-LOCAL pixels (padding rows never
            inside, weight -inf).
        aux: (T, 5) f32 per tile: [tw, th, margin, gain, offset].
        cands: (C, K) int64 tile slots per cell, -1 padded; C = ncy*ncx;
            every other entry is below T, and every gmap entry below N.
        fillval: fill of uncovered pixels.
        out_kind: 'u8' or 'f32'.
    Returns:
        (out (ncy*CELL, ncx*CELL), covered_any bool)
    On a CPU tensor this is ``montage_blend_plain``; on a CUDA tensor one
    launch of the kernel (or an error), whose covered flag is read once.
    """
    if tables.device.type == 'cpu':
        return montage_blend_plain(srcs, lows, gmap, tables, aux, cands,
                                   fillval, ncy, ncx, out_kind, pyramid)
    run, shape, dt = _prepare(srcs, lows, gmap, tables, aux, cands, fillval,
                              ncy, ncx, out_kind, pyramid)
    out = torch.empty(shape, dtype=dt, device=tables.device)
    covered = torch.empty(1, dtype=torch.bool, device=tables.device)
    run(out, covered)
    return out, bool(covered.item())


def pack_tile_stack(srcs_u8):
    """(T, Hs, Ws) uint8 -> packed-quad int32 stack."""
    return pack_u8_quads(srcs_u8)


def pack_low_stack(packed, twth, sigma, chunk=256):
    """PYRAMID low band of a packed stack: per-tile mask-normalized blur
    (mask = the tile's valid rectangle, inclusion 0 < x < tw), quantized
    to uint8 and packed. Processes ``chunk`` tiles at a time."""
    N, H, W = packed.shape
    dev = packed.device
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    y = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    outs = []
    for s in range(0, N, chunk):
        img = (packed[s:s + chunk] & 0xff).to(torch.float32)
        tw = twth[s:s + chunk, 0][:, None, None]
        th = twth[s:s + chunk, 1][:, None, None]
        m = ((x > 0.5) & (x < tw - 0.5) & (y > 0.5) & (y < th - 0.5)).to(
            torch.float32)
        num = gaussian_blur((img * m).contiguous(), sigma)
        den = gaussian_blur(m.contiguous(), sigma)
        low = torch.where(den > 1e-6, num / torch.clamp(den, min=1e-6), img)
        outs.append(pack_u8_quads(torch.clamp(torch.round(low), 0, 255)
                                  .to(torch.uint8)))
    return torch.cat(outs)


def _pow2(n, lo=1):
    return max(lo, 1 << int(max(n - 1, 0)).bit_length())


class _TileTable:
    """Host-side f64 per-triangle data of one tile mesh and its block-local
    14-column coefficient tables (the table construction of
    ``feabas_tpu/ops/render.py:DeviceRenderEngine``)."""

    def __init__(self, mesh, target_gear, source_gear):
        vw = np.asarray(mesh.vertices_w_offset(target_gear), np.float64)
        P = vw[mesh.triangles]
        self._tb = np.concatenate([P.min(axis=1), P.max(axis=1)], axis=1)
        A, b = mesh.triangle_affine_tform(gear0=target_gear, gear1=source_gear)
        self._A = np.asarray(A, np.float64)
        self._b = np.asarray(b, np.float64)
        a = P[:, 0]
        e1 = P[:, 1] - a
        e2 = P[:, 2] - a
        den = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        ok = np.abs(den) > 1e-12
        safe = np.where(ok, den, 1.0)
        # l1/l2 as affine functions of world position
        self._l1 = np.stack([e2[:, 1] / safe, -e2[:, 0] / safe], -1)
        self._l2 = np.stack([-e1[:, 1] / safe, e1[:, 0] / safe], -1)
        self._l1c = -(a * self._l1).sum(-1)
        self._l2c = -(a * self._l2).sum(-1)
        w = np.ones(len(mesh.triangles), np.float64)
        w[~ok] = -np.inf                       # degenerate: never
        self._w = w

    def table_for_block(self, sel, origin):
        """(n, 14) f32 block-local table for triangles ``sel``."""
        ox, oy = origin
        tab = np.zeros((sel.size, 14), np.float32)
        l1 = self._l1[sel]
        l2 = self._l2[sel]
        A = self._A[sel]
        b = self._b[sel]
        tab[:, 0:2] = l1
        tab[:, 2] = self._l1c[sel] + l1[:, 0] * ox + l1[:, 1] * oy
        tab[:, 3:5] = l2
        tab[:, 5] = self._l2c[sel] + l2[:, 0] * ox + l2[:, 1] * oy
        tab[:, 6] = A[:, 0, 0]
        tab[:, 7] = A[:, 1, 0]
        tab[:, 8] = b[:, 0] + ox * A[:, 0, 0] + oy * A[:, 1, 0]
        tab[:, 9] = A[:, 0, 1]
        tab[:, 10] = A[:, 1, 1]
        tab[:, 11] = b[:, 1] + ox * A[:, 0, 1] + oy * A[:, 1, 1]
        tab[:, 12] = self._w[sel]
        tab[:, 13] = -1.0
        return tab


class MontageDeviceEngine:
    """Per-section device montage blender (built lazily by
    ``stitcher.MontageRenderer``); caches per-tile tables and tile images
    across blocks."""

    def __init__(self, renderer, device):
        self._mr = renderer
        self.device = device
        self._tables = {}
        self._tile_host = {}
        self._tile_shape = None
        self._stack = None
        self._stack_low = None
        self._stack_failed = False

    def _table(self, t):
        tt = self._tables.get(t)
        if tt is None:
            tt = _TileTable(self._mr.meshes[t], const.MESH_GEAR_MOVING,
                            const.MESH_GEAR_INITIAL)
            self._tables[t] = tt
        return tt

    def _ensure_tile_shape(self):
        if self._tile_shape is None:
            mx = self._mr._tile_sizes.max(axis=0)
            self._tile_shape = (_pow2(int(round(mx[1])), 8),
                                _pow2(int(round(mx[0])), 8))
        return self._tile_shape

    def _tile_source(self, t, fillval):
        buf = self._tile_host.get(t)
        if buf is not None:
            return buf
        from feabas_tpu_torch.dal import TileView
        tw, th = self._mr._tile_sizes[t]
        tw, th = int(round(tw)), int(round(th))
        hp, wp = self._ensure_tile_shape()
        img = TileView(self._mr.loader, t).crop((0, 0, tw, th))
        buf = np.full((hp, wp), fillval, np.uint8)
        if img is not None:
            im = np.asarray(img)
            if im.dtype != np.uint8:
                im = np.clip(np.rint(im), 0, 255).astype(np.uint8)
            buf[:im.shape[0], :im.shape[1]] = im[:hp, :wp]
        self._tile_host[t] = buf
        return buf

    def _resident_stack(self, fillval):
        """The whole section's packed tiles on the device, uploaded once,
        for sections of at least RESIDENT_STACK_MIN_TILES tiles."""
        if self._stack is not None or self._stack_failed:
            return self._stack
        N = len(self._mr.meshes)
        hp, wp = self._ensure_tile_shape()
        if N < RESIDENT_STACK_MIN_TILES or N * hp * wp * 4 > RESIDENT_STACK_CAP:
            self._stack_failed = True
            return None
        buf = np.stack([self._tile_source(t, fillval) for t in range(N)])
        self._stack = pack_tile_stack(torch.as_tensor(buf, device=self.device))
        self._tile_host.clear()
        return self._stack

    def supported(self, blend):
        mr = self._mr
        return (blend in ('LINEAR', 'PYRAMID') and not mr._maskouts
                and getattr(mr.loader, 'number_of_channels', 1) in (None, 1)
                and np.dtype(mr.loader.dtype) == np.uint8)

    def _low_of(self, packed, twth):
        return pack_low_stack(packed, torch.as_tensor(twth, device=self.device),
                              float(self._mr._pyramid_sigma))

    def block_inputs(self, bbox, hits, blend, fillval):
        """``montage_blend``'s arguments for one block (tiles ``hits``) and
        the block's (H, W): (args, H, W); None when no tile touches a cell,
        NotImplemented when a cell touches more than K_CAP tiles."""
        mr = self._mr
        pyramid = blend == 'PYRAMID'
        xbase = int(np.floor(bbox[0]))
        ybase = int(np.floor(bbox[1]))
        H = int(np.ceil(bbox[3])) - ybase
        W = int(np.ceil(bbox[2])) - xbase
        ncy = -(-H // CELL)
        ncx = -(-W // CELL)
        hits = [int(t) for t in hits]
        cells = [[] for _ in range(ncy * ncx)]
        for local, t in enumerate(hits):
            tb = mr._bounds[t]
            cx0 = max(int((tb[0] - xbase) // CELL), 0)
            cy0 = max(int((tb[1] - ybase) // CELL), 0)
            cx1 = min(int(np.ceil((tb[2] - xbase) / CELL)), ncx)
            cy1 = min(int(np.ceil((tb[3] - ybase) / CELL)), ncy)
            for cy in range(cy0, cy1):
                for cx in range(cx0, cx1):
                    cells[cy * ncx + cx].append(local)
        kmax = max((len(c) for c in cells), default=0)
        if kmax == 0:
            return None
        if kmax > K_CAP:
            return NotImplemented
        cands = np.full((ncy * ncx, kmax), -1, np.int64)
        for ci, lst in enumerate(cells):
            cands[ci, :len(lst)] = lst
        stack = self._resident_stack(fillval)
        tabs = []
        aux = np.zeros((len(hits), 5), np.float32)
        for local, t in enumerate(hits):
            tt = self._table(t)
            sel = np.nonzero(
                (tt._tb[:, 0] < xbase + W) & (tt._tb[:, 2] > xbase) &
                (tt._tb[:, 1] < ybase + H) & (tt._tb[:, 3] > ybase))[0]
            tabs.append(tt.table_for_block(sel, (xbase, ybase)))
            tw, th = mr._tile_sizes[t]
            margin = mr._blend_margin
            if margin is None:
                margin = max(min(tw, th) / 16.0, 1.0)
            g, o = (1.0, 0.0)
            if mr._transfers is not None:
                g, o = mr._transfers[t]
            aux[local] = (tw, th, margin, g, o)
        R = max(max(t.shape[0] for t in tabs), 1)
        tables = np.zeros((len(hits), R, 14), np.float32)
        tables[:, :, 2] = -2.0           # padding rows: l1 < 0, never inside
        tables[:, :, 12] = -np.inf
        tables[:, :, 13] = -1.0
        for k, t in enumerate(tabs):
            tables[k, :t.shape[0]] = t
        dev = self.device
        if stack is not None:
            packed = stack
            if pyramid and self._stack_low is None:
                self._stack_low = self._low_of(
                    packed, np.asarray(mr._tile_sizes, np.float32))
            lows = self._stack_low if pyramid else packed
            gmap = np.asarray(hits, np.int64)
        else:
            srcs = np.stack([self._tile_source(t, fillval) for t in hits])
            packed = pack_tile_stack(torch.as_tensor(srcs, device=dev))
            lows = self._low_of(packed, aux[:, :2]) if pyramid else packed
            gmap = np.arange(len(hits), dtype=np.int64)
        args = (packed, lows, torch.as_tensor(gmap, device=dev),
                torch.as_tensor(tables, device=dev),
                torch.as_tensor(aux, device=dev),
                torch.as_tensor(cands, device=dev), float(fillval), ncy, ncx,
                'u8', pyramid)
        return args, H, W

    def render_block(self, bbox, hits, blend, fillval):
        """LINEAR/PYRAMID blend of one block on the device: an array, None
        (nothing covered) or NotImplemented (the host path is needed)."""
        if not self.supported(blend):
            return NotImplemented
        inputs = self.block_inputs(bbox, hits, blend, fillval)
        if inputs is None or inputs is NotImplemented:
            return inputs
        args, H, W = inputs
        out, covered = montage_blend(*args)
        if not covered:
            return None
        return out[:H, :W].cpu().numpy()

    def render_blocks(self, blocks, blend, fillval):
        """``render_block`` over a list of bboxes."""
        out = []
        for bbox in blocks:
            hits = self._mr._index.query(bbox)
            out.append(None if hits.size == 0 else
                       self.render_block(bbox, hits, blend, fillval))
        return out
