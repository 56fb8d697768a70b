"""Seconds a pair of the window's units spent inside the harness's
feature-match spans (``thumbnail.match_two_thumbnails_LRadon``: the
robustness rounds' descriptor matches and filters, RANSAC, the elastic
verification and the subpixel refinement)."""


def read(t):
    s = t.span_s.get('thumbnail.match')
    return s / t.units if s is not None and t.units > 0 else None
