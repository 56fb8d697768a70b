"""Share of the image files written that were written side by side (the
program's counters ``render.batched_encodes`` over ``blender.encodes``,
counted where ``common.imwrite_many`` writes a list of files at a width
above one, the mesh renderer's card route writing a wave's tiles so, and
in ``common.imwrite``).

The harness reads the counters after the window without zeroing them
before it, so they cover every unit of the run, the set-up's untimed one
included. None where the program has no ``imwrite_many`` (and so keeps no
such counter) or encoded nothing."""


def read(t):
    try:
        from feabas_tpu_torch import common, trace
    except ImportError:
        return None
    if not hasattr(common, 'imwrite_many'):
        return None
    c = trace.counters()
    n = c.get('blender.encodes', 0)
    return 100.0 * c.get('render.batched_encodes', 0) / n if n > 0 else None
