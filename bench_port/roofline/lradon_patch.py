"""The LRadon descriptors' patch stage (``ops/lradon.lradon_patch``: each
keypoint's patch blended by its fractional offset, the stencil table's
products, the normalisation), counted as ``chip_smoke.py``
``_lradon_bound`` counts it, but for the image: 2 FLOP a non-zero tap of
the stencil table a keypoint, 12 a descriptor entry; the table, the
keypoints' origins and offsets and the descriptors each once, and of the
image the pixels some keypoint's window reads, each once ((Dp + 1)^2
pixels about the keypoint, clamped into the image: the whole plane where
the windows cover it, as in ``chip_smoke.py``'s cases; far less of a 4096^2
thumbnail's)."""

import torch

from roofline.common import bound
from roofline.launch_range import ranged

KERNEL = 'lradon_patch'
# the device kernel's name in the trace (its ``__global__`` in csrc/)
NAME = r'\(anonymous namespace\)::patch_kernel\b'
MODULE, ATTR = 'feabas_tpu_torch.ops.lradon', 'lradon_patch'


def window_pixels(h, w, z, Rp):
    """Pixels of the (h, w) image that the windows at patch origins ``z``
    (K, 2) (x, y in the frame edge-padded by Rp + 1) read, each once."""
    lo = z.long() - (Rp + 1)
    n = 2 * Rp + 2
    x0 = lo[:, 0].clamp(0, w - 1)
    x1 = (lo[:, 0] + n).clamp(1, w)
    y0 = lo[:, 1].clamp(0, h - 1)
    y1 = (lo[:, 1] + n).clamp(1, h)
    d = torch.zeros((h + 1, w + 1), dtype=torch.int32, device=z.device)
    one = torch.ones_like(x0, dtype=torch.int32)
    for ys, xs, s in ((y0, x0, one), (y0, x1, -one), (y1, x0, -one),
                      (y1, x1, one)):
        d.index_put_((ys, xs), s, accumulate=True)
    cover = d.cumsum(0).cumsum(1)[:h, :w]
    return int((cover > 0).sum())


def call_bound(pk, h, w, z, W, Rp):
    K, out = z.shape[0], W.shape[1]
    flop = K * (2 * int(W.count_nonzero()) + 12 * out)
    nbytes = 4 * (window_pixels(h, w, z, Rp) + 4 * K + W.numel() + K * out)
    return bound(pk, flop, nbytes)


def wrap(orig, record):
    """``lradon_patch`` recording each call on the card. The bound reads
    the origins and the table, so it is worked out after the window
    (``bound`` is a function): the traced window gains no host sync."""
    def lradon_patch(img, z, f, tables, proj_num, Rp):
        if img.device.type != 'cuda':
            return orig(img, z, f, tables, proj_num, Rp)
        h, w = img.shape
        W = tables[0]

        def later():
            return call_bound(record.peaks, h, w, z, W, int(Rp))
        return record(KERNEL, later, ranged(KERNEL, orig), img, z, f,
                      tables, proj_num, Rp)
    return lradon_patch
