"""Seconds a Mpx of the window's units spent inside the spans around the
volume writer's store writes (``TensorStoreWriter.write_slab`` and
``write_single_chunk``: the transpose of a chunk's layers to the store's
(x, y, z) order and the write of its chunk file)."""


def read(t):
    s = t.span_s.get('volume.write')
    return s / t.mpx if s is not None and t.mpx > 0 else None
