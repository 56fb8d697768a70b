"""Seconds a Mpx of the window's units spent inside the blender's spans
(``MontageRenderer.render_series_to_file``)."""


def read(t):
    s = t.span_s.get('blender')
    return s / t.mpx if s is not None and t.mpx > 0 else None
