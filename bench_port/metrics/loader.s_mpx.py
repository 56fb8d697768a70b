"""Seconds a Mpx of the window's units spent inside the loader's spans
(``align_main._maybe_stream``: the section decoded and downscaled to
the working mip)."""


def read(t):
    s = t.span_s.get('loader')
    return s / t.mpx if s is not None and t.mpx > 0 else None
