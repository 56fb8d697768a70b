"""Seconds a pair of the window's units spent inside the harness's
feature spans (``thumbnail.prepare_image``: a thumbnail's detection and
descriptors, two a pair)."""


def read(t):
    s = t.span_s.get('thumbnail.features')
    return s / t.units if s is not None and t.units > 0 else None
