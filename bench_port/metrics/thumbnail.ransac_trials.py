"""RANSAC draws an affine fit (the program's counters
``thumbnail.ransac_trials`` over ``thumbnail.ransac_calls``, counted by
``thumbnail.py``'s global RANSAC as each fit ends).

The harness reads the counters after the window without zeroing them
before it, so they cover every unit of the run, the set-up's untimed one
included. None where the program keeps no such counter or ran no fit."""


def read(t):
    try:
        from feabas_tpu_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    n = c.get('thumbnail.ransac_calls', 0)
    return c.get('thumbnail.ransac_trials', 0) / n if n > 0 else None
