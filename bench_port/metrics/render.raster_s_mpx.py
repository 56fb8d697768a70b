"""Seconds a Mpx of the window's units spent inside the mesh renderer's
spans (``MeshRenderer.crop_multiple`` and ``MeshRenderer.crop``: the
source crops, tables and raster of the card route, or the field and
``cv2.remap`` of the host route)."""


def read(t):
    s = t.span_s.get('render.raster')
    return s / t.mpx if s is not None and t.mpx > 0 else None
