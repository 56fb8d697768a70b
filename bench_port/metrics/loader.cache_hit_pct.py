"""Share of the image loaders' cache lookups that found their image or
border band (the program's counters ``loader.cache_hits`` over
``loader.cache_lookups``, counted where ``dal.py`` gets from its cache).

The harness reads the counters after the window without zeroing them
before it, so they cover every unit of the run, the set-up's untimed one
included. None where the program keeps no such counter or made no
lookup."""


def read(t):
    try:
        from feabas_tpu_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    n = c.get('loader.cache_lookups', 0)
    return 100.0 * c.get('loader.cache_hits', 0) / n if n > 0 else None
