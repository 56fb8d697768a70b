"""The detector's peak response (``ops/lradon.peak_response``: |f| where it
is the maximum of its size x size window, positive and inside the mask;
-inf elsewhere), counted as ``chip_smoke.py`` ``_lradon_bound`` counts it:
the plane read and the response written once (and the mask read once where
there is one), 2 size + 3 FLOP a pixel (the separable window maximum, the
compares and the select)."""

from roofline.common import bound
from roofline.launch_range import ranged

KERNEL = 'peak_detect'
# the device kernel's name in the trace (its ``__global__`` in csrc/)
NAME = r'\(anonymous namespace\)::peak_kernel\b'
MODULE, ATTR = 'feabas_tpu_torch.ops.lradon', 'peak_response'


def call_bound(pk, px, size, masked):
    return bound(pk, px * (2 * size + 3), px * (8 + (4 if masked else 0)))


def wrap(orig, record):
    """``peak_response`` recording each call on the card with its bound,
    which the shapes settle: no device value is read."""
    def peak_response(f, mask=None, size=10):
        if f.device.type != 'cuda':
            return orig(f, mask, size)
        b = call_bound(record.peaks, f.numel(), int(size), mask is not None)
        return record(KERNEL, b, ranged(KERNEL, orig), f, mask, size)
    return peak_response
