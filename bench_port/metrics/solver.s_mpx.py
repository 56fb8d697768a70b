"""Seconds a Mpx of the window's units spent inside the solver's spans
(the ``Stitcher.optimize_*`` calls of ``stitch_main.optimize_main``)."""


def read(t):
    s = t.span_s.get('solver')
    return s / t.mpx if s is not None and t.mpx > 0 else None
