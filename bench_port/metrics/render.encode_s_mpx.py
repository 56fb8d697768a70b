"""Seconds a Mpx of the window's units spent inside the spans around
``common.imwrite`` (each output tile's PNG encode and write)."""


def read(t):
    s = t.span_s.get('render.encode')
    return s / t.mpx if s is not None and t.mpx > 0 else None
