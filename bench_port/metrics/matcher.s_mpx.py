"""Seconds a Mpx of the window's units spent inside the matcher's spans
(``Stitcher.dispatch_matchers``, ``matcher.section_matcher``)."""


def read(t):
    s = t.span_s.get('matcher')
    return s / t.mpx if s is not None and t.mpx > 0 else None
