"""Seconds a pair of the window's units spent inside the harness's
refinement spans (``thumbnail.match_two_thumbnails_pmcc``: the PMCC block
matching that ``matcher.section_matcher`` runs from the coarse matches)."""


def read(t):
    s = t.span_s.get('thumbnail.refine')
    return s / t.units if s is not None and t.units > 0 else None
