"""The plain reference of the align.tsr cell: a neuroglancer-precomputed
volume read back without the program's store, and the volume a tsr call
should write, in plain PyTorch and numpy (no program code, no kernel, no
cache).

``read_precomputed`` parses the volume's ``info`` JSON and its raw chunk
files itself (it does not go through the program's ``_tslite`` or
tensorstore, so a fault the program's writer and its reader share still
shows): a scale's chunks are files ``x0-x1_y0-y1_z0-z1`` under the scale's
``key``, in the volume's voxel coordinates (its ``voxel_offset``
included), clipped at the volume's end; a raw chunk holds its voxels
little-endian in C order of (channel, z, y, x). A chunk whose file is
absent was never written.

``expected_chunk`` is the volume's content over one xy chunk: for each
section, ``reference/render.render`` of the section through its mesh over
the chunk's box (Lanczos-4 sampling by OpenCV's weights, computed in
float32 unless asked otherwise), stacked along z. TF32 is off while it
computes (it multiplies no matrix; the guard keeps it so).
"""

import json
import os
from contextlib import contextmanager

import numpy as np
import torch

from reference.render import render


def read_precomputed(path, scale=0):
    """Scale ``scale`` of the raw precomputed volume at ``path``: a dict of
    ``data`` (c, z, y, x) in the volume's dtype (zero where no chunk file
    is), ``present`` (chunks along z, y, x: whether each chunk's file is
    there), ``chunk`` (x, y, z) and ``offset`` (the voxel offset, x, y,
    z). Raises ValueError where the volume is not one this reads (another
    encoding, sharded) or a chunk file holds another number of bytes than
    its clipped extent."""
    with open(os.path.join(path, 'info')) as f:
        info = json.load(f)
    sc = info['scales'][scale]
    if sc.get('encoding', 'raw') != 'raw':
        raise ValueError(f'{path}: encoding {sc.get("encoding")!r}, not raw')
    if sc.get('sharding'):
        raise ValueError(f'{path}: a sharded scale')
    stored = np.dtype(info['data_type']).newbyteorder('<')
    nc = int(info.get('num_channels', 1))
    size = [int(v) for v in sc['size']]
    chunk = [int(v) for v in sc['chunk_sizes'][0]]
    off = [int(v) for v in sc.get('voxel_offset', (0, 0, 0))]
    grid = [-(-s // c) for s, c in zip(size, chunk)]
    data = np.zeros((nc, size[2], size[1], size[0]),
                    np.dtype(info['data_type']))
    present = np.zeros((grid[2], grid[1], grid[0]), bool)
    root = os.path.join(path, sc['key'])
    for k in range(grid[2]):
        for j in range(grid[1]):
            for i in range(grid[0]):
                lo = [i * chunk[0], j * chunk[1], k * chunk[2]]
                hi = [min(a + c, s) for a, c, s in zip(lo, chunk, size)]
                name = '_'.join(f'{a + o}-{b + o}'
                                for a, b, o in zip(lo, hi, off))
                fn = os.path.join(root, name)
                if not os.path.exists(fn):
                    continue
                X, Y, Z = (b - a for a, b in zip(lo, hi))
                raw = np.fromfile(fn, stored)
                if raw.size != nc * Z * Y * X:
                    raise ValueError(f'{fn}: {raw.size} voxels, not '
                                     f'{nc} x {Z} x {Y} x {X}')
                data[:, lo[2]:hi[2], lo[1]:hi[1], lo[0]:hi[0]] = \
                    raw.reshape(nc, Z, Y, X)
                present[k, j, i] = True
    return {'data': data, 'present': present, 'chunk': chunk, 'offset': off}


@contextmanager
def _no_tf32():
    """TF32 off for matrix products and cuDNN inside the block, restored
    after it."""
    mm = torch.backends.cuda.matmul.allow_tf32
    dnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn


def expected_chunk(sections, meshes, bbox, fillval=0.0, dtype=torch.float32):
    """(Z, h, w) uint8 layers of the output bbox (x0, y0, x1, y1) and their
    (Z, h, w) coverage: ``sections`` the Z sections (H, W) on the device
    the output is made on, in z order; ``meshes`` each section's
    (output-frame vertices, source vertices, triangles)."""
    with _no_tf32():
        outs = [render(src, tgt, srcv, tris, bbox, fillval, dtype)
                for src, (tgt, srcv, tris) in zip(sections, meshes)]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([c for _, c in outs]))
