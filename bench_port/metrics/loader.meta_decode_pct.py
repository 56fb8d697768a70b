"""Share of the image loaders' metadata reads that decoded a whole image
(the program's counters ``loader.meta_decodes`` over ``loader.meta_headers``
+ ``loader.meta_decodes``, counted where ``dal.py`` learns a first tile's
dtype and channels: from its header where the format allows, else from a
decode).

The harness reads the counters after the window without zeroing them
before it, so they cover every unit of the run, the set-up's untimed one
included. None where the program keeps no such counter or read no
metadata."""


def read(t):
    try:
        from feabas_tpu_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    decodes = c.get('loader.meta_decodes', 0)
    n = c.get('loader.meta_headers', 0) + decodes
    return 100.0 * decodes / n if n > 0 else None
