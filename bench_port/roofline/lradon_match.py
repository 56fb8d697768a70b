"""The rotation-exhaustive descriptor match (``ops/lradon.lradon_match``:
the similarity of every valid pair under each of the 2P rotation variants,
the best variant, the mutual-nearest check and the ratio test), counted as
``chip_smoke.py`` ``_lradon_bound`` counts it, of the rows the masks keep
(a robustness round after the first matches the keypoints still active):
2 FLOP a product of every variant and a compare per reduction and pair;
the kept rows' descriptors and both masks read once, the four result
vectors and the best variant written once."""

from roofline.common import bound
from roofline.launch_range import ranged

KERNEL = 'lradon_match'
# the device kernels' names in the trace (their ``__global__`` in csrc/)
NAME = (r'\(anonymous namespace\)::'
        r'(?:prep|variant_max|reduce|finish)_kernel\b')
MODULE, ATTR = 'feabas_tpu_torch.ops.lradon', 'lradon_match'


def call_bound(pk, K0, K1, k0, k1, dlen, nvar):
    """K0, K1 the rows of each side, k0, k1 those the masks keep."""
    flop = nvar * 2 * k0 * k1 * dlen + (nvar + 3) * k0 * k1
    nbytes = 4 * (k0 + k1) * dlen + K0 + K1 + 13 * K1 + 4
    return bound(pk, flop, nbytes)


def wrap(orig, record):
    """``lradon_match`` recording each call on the card. The kept rows are
    counted from the masks after the window (``bound`` is a function): the
    traced window gains no host sync."""
    def lradon_match(d0, v0, d1, v1, proj_num, exhaustive=True):
        if d0.device.type != 'cuda':
            return orig(d0, v0, d1, v1, proj_num, exhaustive)
        dlen = int(d0.shape[1] * d0.shape[2])
        nvar = 2 * int(proj_num) if exhaustive else 1

        def later():
            return call_bound(record.peaks, d0.shape[0], d1.shape[0],
                              int(v0.sum()), int(v1.sum()), dlen, nvar)
        return record(KERNEL, later, ranged(KERNEL, orig), d0, v0, d1, v1,
                      proj_num, exhaustive)
    return lradon_match
