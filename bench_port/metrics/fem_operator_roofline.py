"""The general CG operator's share of its roofline: the bound of every
call (``roofline/fem_operator.py``, from the call's arguments) over the
device time of everything the calls launched."""

import roofline.share


def read(t):
    return roofline.share.of(t, 'fem_operator')
