"""Source Mpx decoded for each Mpx of section layers rendered into the
volume (the program's counters ``loader.decoded_px``, counted in
``common.imread``, over ``volume.layer_px``, counted where the volume
renderer writes a chunk): 1 where each source tile is decoded once, more
where an uncached loader decodes a tile again for every chunk and layer
that reads it.

The harness reads the counters after the window without zeroing them
before it, so they cover every unit of the run, the set-up's untimed one
included. None where the program keeps no ``volume.layer_px`` counter
(as before the volume renderer counted its layers) or rendered no
layer."""


def read(t):
    try:
        from feabas_tpu_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    px = c.get('volume.layer_px', 0)
    return c.get('loader.decoded_px', 0) / px if px > 0 else None
