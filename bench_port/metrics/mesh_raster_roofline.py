"""The mesh raster's share of its roofline: the bound of every call
(``roofline/mesh_raster.py``, from the call's arguments) over the device
time of everything the calls launched. None where the window rendered
nothing on the card (the host route)."""

import roofline.share


def read(t):
    return roofline.share.of(t, 'mesh_raster')
