"""The table of peaks and the least time of a call from its work.

Every kernel module beside this file counts what its function needs from
the arguments of one call (each input byte read once, each output byte
written once), whatever kernel, fused kernel or graph does the work, and
hands the harness a wrapper that records that bound for each call.
"""

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'peaks.json')


def peaks(card):
    """The published peaks of ``card`` (``torch.cuda.get_device_name``),
    or None for a card the table does not hold: its rooflines are then
    not reported."""
    with open(_PEAKS) as f:
        return json.load(f).get(card)


def bound(pk, flop, nbytes, dtype='float32'):
    """Seconds the card needs at least for ``flop`` operations in
    ``dtype`` and ``nbytes`` of memory traffic."""
    return max(flop / pk[dtype + '_flops'], nbytes / pk['bytes'])
