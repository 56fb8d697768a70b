"""Share of the image decodes that a crop issued on the loaders' decode
pool (the program's counters ``loader.batched_decodes`` over
``loader.decodes``, counted where ``dal.py`` decodes a multi-tile crop's
uncached tiles side by side, and in ``common.imread``).

The harness reads the counters after the window without zeroing them
before it, so they cover every unit of the run, the set-up's untimed one
included. None where the program has no decode pool (and so keeps no
such counter) or decoded nothing."""


def read(t):
    try:
        from feabas_tpu_torch import dal, trace
    except ImportError:
        return None
    if not hasattr(dal, 'decode_pool'):
        return None
    c = trace.counters()
    n = c.get('loader.decodes', 0)
    return 100.0 * c.get('loader.batched_decodes', 0) / n if n > 0 else None
