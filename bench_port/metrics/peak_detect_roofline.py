"""The detector's peak response (K15) share of its roofline: the bound of
every call (``roofline/peak_detect.py``, from the call's arguments) over
the device time of everything the calls launched."""

import roofline.share


def read(t):
    return roofline.share.of(t, 'peak_detect')
