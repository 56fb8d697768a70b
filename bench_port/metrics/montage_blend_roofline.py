"""The montage blend's share of its roofline: the bound of every
call (``roofline/montage_blend.py``, from the call's arguments) over the
device time of everything the calls launched."""

import roofline.share


def read(t):
    return roofline.share.of(t, 'montage_blend')
