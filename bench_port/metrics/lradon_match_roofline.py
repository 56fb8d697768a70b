"""The rotation-exhaustive descriptor match (K17) share of its roofline:
the bound of every call (``roofline/lradon_match.py``, from the call's
arguments) over the device time of everything the calls launched."""

import roofline.share


def read(t):
    return roofline.share.of(t, 'lradon_match')
