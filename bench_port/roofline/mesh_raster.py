"""The mesh raster (``ops/render.raster_blocks``: B output blocks of h x w
px, each pixel's source coordinate from its triangle's affine map, snapped
to 1/32 px and sampled), counted from the call's arguments, whatever
kernel does the work: per output px, its source coordinate (two affine
maps, 4 FLOP each) and its snap (3 FLOP an axis), then the sample:
bilinear, 4 taps of a multiply-add and their 4 weight terms (12 FLOP);
Lanczos-4, 64 taps of a multiply-add and the 16 weight terms (144 FLOP).
The inside tests that find each pixel's triangle depend on the mesh and
are not counted. Bytes: the output written once; the triangle tables,
cell candidates and per-block extents read once; the source read once: a
per-block crop whole, a source shared by the blocks at most one window of
(h + taps - 1) x (w + taps - 1) px a block."""

from roofline.common import bound

KERNEL = 'mesh_raster'
# the device kernel's name in the trace (its ``__global__`` in csrc/)
NAME = r'\(anonymous namespace\)::raster<'
MODULE, ATTR = 'feabas_tpu_torch.ops.render', 'raster_blocks'

COORD_FLOP = 2 * 4 + 2 * 3
SAMPLE = {'linear': (4 * 2 + 4, 2), 'lanczos4': (64 * 2 + 16, 8)}
OUT_BYTES = {'u8': 1, 'u16': 2, 'f32': 4}


def call_bound(pk, src, tables, cands, h, w, out_kind, interp='linear',
               src_hw=None):
    flop_px, taps = SAMPLE[interp]
    B = tables.shape[0]
    px = B * h * w
    src_px = src.numel()
    if src.dim() == 2:
        src_px = min(src_px, B * (h + taps - 1) * (w + taps - 1))
    nbytes = (px * OUT_BYTES[out_kind] + src_px * src.element_size()
              + 4 * tables.numel()
              + (4 * cands.numel() if cands is not None else 0)
              + (8 * B if src_hw is not None else 0))
    return bound(pk, px * (COORD_FLOP + flop_px), nbytes)


def wrap(orig, record):
    """``raster_blocks`` recording each call on the card with its bound,
    which the shapes settle: no device value is read."""
    def raster_blocks(src, tables, cands, fillval, h, w, geodesic, out_kind,
                      *args, **kwargs):
        if tables.device.type != 'cuda':
            return orig(src, tables, cands, fillval, h, w, geodesic,
                        out_kind, *args, **kwargs)
        src_hw = args[0] if args else kwargs.get('src_hw')
        b = call_bound(record.peaks, src, tables, cands, int(h), int(w),
                       out_kind, kwargs.get('interp', 'linear'), src_hw)
        return record(KERNEL, b, orig, src, tables, cands, fillval, h, w,
                      geodesic, out_kind, *args, **kwargs)
    return raster_blocks
