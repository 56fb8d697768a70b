"""Share of the coarse matches whose subpixel shift was measured and
written (the program's counters ``thumbnail.subpixel_kept`` over
``thumbnail.coarse_matches``, counted by ``thumbnail.py``: the matches
whose correlation peak was strong and inside the search, over every match
the feature stage returned).

The harness reads the counters after the window without zeroing them
before it, so they cover every unit of the run, the set-up's untimed one
included. None where the program keeps no such counter, made no call of
the refinement or returned no coarse match."""


def read(t):
    try:
        from feabas_tpu_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    n = c.get('thumbnail.coarse_matches', 0)
    if c.get('thumbnail.subpixel_calls', 0) == 0 or n == 0:
        return None
    return 100.0 * c.get('thumbnail.subpixel_kept', 0) / n
