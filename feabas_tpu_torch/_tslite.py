"""A minimal stand-in for the part of tensorstore the port calls, for hosts
without tensorstore.

``feabas_tpu_torch.dal`` imports this module in place of tensorstore on a
host that lacks it (the GPU machine this port targets has none); every
other module of the port reaches it through ``dal.ts``. Where tensorstore
is installed it is always used.

What it writes and reads: neuroglancer-precomputed volumes on a local
``file`` kvstore, unsharded, with ``raw`` or ``jpeg`` encoding. The
``info`` JSON and the chunk files are laid out as tensorstore lays them
out: a scale's key is its resolution joined by ``_`` (``%g`` per value);
each chunk is a file ``x0-x1_y0-y1_z0-z1`` under the key, clipped at the
volume's edge; a raw chunk holds the voxels little-endian in C order of
(channel, z, y, x); a jpeg chunk (uint8, one channel) is one grayscale
JPEG of height y*z and width x. A chunk never written reads as 0. A
write that covers part of a chunk reads it, merges and writes it back;
each chunk file and ``info`` is replaced atomically (a temporary file in
the same directory, then ``os.replace``), under an ``flock`` of its
directory, so that two processes never interleave one read-modify-write.
Opening with ``create`` and ``open`` a scale whose key is new appends it
to ``info.scales``; an existing key is checked against the spec and
opened.

Views over a volume: ``downsample`` (``mean``, ``max``, ``min``; one
factor per dimension, straight from its base, stacked specs applied one
after the other) and ``cast``. ``mean`` over a block at the volume's edge
averages the voxels that are there; an integer mean rounds half to even;
a float mean sums in the type, one voxel of each block at a time in the
order the base holds them (x fastest for a stored volume). tensorstore's
order differs where a block crosses chunks, so a float mean can differ
from tensorstore's in its last bits (integer means, ``max``, ``min`` and
means of integer-valued floats are equal bit for bit).

API subset: ``open(spec).result()``; ``Transaction()`` with
``commit_async().result(timeout=...)`` and ``aborted``; on a store: ``rank``, ``shape``, ``dtype.name``,
``domain[i].inclusive_min`` / ``.exclusive_max``,
``chunk_layout.read_chunk.shape``, ``spec().to_json()``, basic indexing
(integers, unit-step slices, ``...``) in the volume's own coordinates,
``read().result()``, ``write(array).result(timeout=...)``, item
assignment and ``with_transaction(txn)`` (writes are held by the
transaction and applied at its commit). Anything else raises
``UnsupportedSpec``, naming what is missing: zarr and n5 (tensorstore's
default compressor for both is blosc, which this module does not have),
the sharded precomputed format, kvstores other than a local file.
"""

import builtins
import fcntl
import json
import math
import os
import tempfile
from contextlib import contextmanager, nullcontext

import numpy as np

_LABELS = ('x', 'y', 'z', 'channel')
_JPEG_QUALITY = 75


class UnsupportedSpec(ValueError):
    """A spec this module cannot serve; tensorstore can."""


class _Future:
    """A finished operation: ``result()`` returns its value."""

    def __init__(self, value=None):
        self._value = value

    def result(self, timeout=None):
        return self._value


class _DType:
    def __init__(self, dtype):
        self.numpy_dtype = np.dtype(dtype)
        self.name = self.numpy_dtype.name


class _Dim:
    def __init__(self, lo, hi, label):
        self.inclusive_min, self.exclusive_max = int(lo), int(hi)
        self.size = self.exclusive_max - self.inclusive_min
        self.label = label


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(int(s) for s in shape)


class _ChunkLayout:
    def __init__(self, shape):
        self.read_chunk = self.write_chunk = _Shape(shape)


class _Spec:
    def __init__(self, js):
        self._js = js

    def to_json(self):
        return json.loads(json.dumps(self._js))


@contextmanager
def _dir_lock(path):
    """An exclusive ``flock`` of directory ``path`` for the block."""
    fd = os.open(path, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)            # closing releases the lock


def _replace(path, data):
    """Write ``data`` (bytes) to ``path`` atomically."""
    d, name = os.path.split(path)
    fd, tmp = tempfile.mkstemp(prefix=f'.{name}.', suffix='.tmp', dir=d)
    try:
        with os.fdopen(fd, 'wb') as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _info_bytes(info):
    return json.dumps(info, separators=(',', ':'), sort_keys=True).encode()


def scale_key(resolution):
    """The key tensorstore gives a scale of this resolution."""
    return '_'.join('%g' % float(r) for r in resolution)


def _file_path(kvstore):
    if isinstance(kvstore, str):
        if kvstore.startswith('file://'):
            return kvstore[len('file://'):]
        raise UnsupportedSpec(f'kvstore {kvstore!r}: only local file paths '
                              '(file://) are served without tensorstore')
    driver = kvstore.get('driver')
    if driver != 'file':
        raise UnsupportedSpec(f'kvstore driver {driver!r}: only the local '
                              '"file" kvstore is served without tensorstore')
    return str(kvstore['path'])


# ------------------------------ precomputed ------------------------------ #

class _Precomputed:
    """One scale of a neuroglancer-precomputed volume."""

    def __init__(self, root, info, index):
        self.root = root
        self.info = info
        self.index = index
        sc = info['scales'][index]
        self.scale = sc
        self.dir = os.path.join(root, sc['key'])
        self.dtype = np.dtype(info['data_type'])
        self.nc = int(info.get('num_channels', 1))
        self.chunk = [int(c) for c in sc['chunk_sizes'][0]] + [self.nc]
        off = [int(v) for v in sc.get('voxel_offset', (0, 0, 0))]
        self.lo = off + [0]
        self.hi = [o + int(s) for o, s in zip(off, sc['size'])] + [self.nc]
        self.encoding = sc['encoding']
        self.labels = _LABELS

    def spec_json(self):
        sm = {k: v for k, v in self.scale.items() if k != 'chunk_sizes'}
        sm['chunk_size'] = self.scale['chunk_sizes'][0]
        sm.setdefault('sharding', None)
        return {'driver': 'neuroglancer_precomputed', 'dtype': self.dtype.name,
                'kvstore': {'driver': 'file',
                            'path': self.root.rstrip('/') + '/'},
                'multiscale_metadata': {'num_channels': self.nc,
                                        'type': self.info.get('type',
                                                              'image')},
                'scale_index': self.index, 'scale_metadata': sm,
                'transform': {'input_inclusive_min': list(self.lo),
                              'input_exclusive_max': list(self.hi),
                              'input_labels': list(_LABELS)}}

    def _cells(self, box):
        """(chunk file name, cell box, part of ``box`` in the cell) for each
        chunk cell ``box`` meets; boxes are [(lo, hi)] over (x, y, z, c)."""
        ranges = []
        for d in range(3):
            lo, hi = box[d]
            c, o = self.chunk[d], self.lo[d]
            k0, k1 = (lo - o) // c, -(-(hi - o) // c)
            ranges.append([(o + k * c, min(o + (k + 1) * c, self.hi[d]))
                           for k in range(k0, k1)])
        for cx in ranges[0]:
            for cy in ranges[1]:
                for cz in ranges[2]:
                    cell = [cx, cy, cz, (0, self.nc)]
                    part = [(max(a, lo), min(b, hi))
                            for (a, b), (lo, hi) in zip(cell, box)]
                    name = '_'.join(f'{a}-{b}' for a, b in cell[:3])
                    yield name, cell, part

    def load(self, name, cell, zs=None):
        """The chunk's voxels as an (x, y, z, c) array, or None where the
        chunk was never written; with ``zs`` = (z0, z1) only those layers
        (a raw chunk reads only their bytes)."""
        path = os.path.join(self.dir, name)
        shape = [b - a for a, b in cell]
        z0, z1 = (0, shape[2]) if zs is None else \
            (zs[0] - cell[2][0], zs[1] - cell[2][0])
        try:
            f = builtins.open(path, 'rb')
        except FileNotFoundError:
            return None
        with f:
            if self.encoding == 'raw':
                X, Y, Z, C = shape
                layer = X * Y * self.dtype.itemsize
                if os.fstat(f.fileno()).st_size != layer * Z * C:
                    raise ValueError(f'{path}: not a {shape} raw chunk')
                parts = []
                for c in range(C):
                    f.seek((c * Z + z0) * layer)
                    parts.append(np.frombuffer(
                        f.read((z1 - z0) * layer),
                        self.dtype.newbyteorder('<')))
                a = np.concatenate(parts).reshape(C, z1 - z0, Y, X)
                return a.astype(self.dtype, copy=False).transpose(3, 2, 1, 0)
            buf = f.read()
        import cv2
        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_GRAYSCALE)
        if img is None or img.shape != (shape[2] * shape[1], shape[0]):
            raise ValueError(f'{path}: not a {shape} jpeg chunk')
        return img.reshape(shape[2], shape[1], shape[0]).transpose(
            2, 1, 0)[:, :, z0:z1, None]

    def store(self, name, chunk):
        """Replace the chunk file ``name`` with ``chunk`` (x, y, z, c)."""
        if self.encoding == 'raw':
            data = np.ascontiguousarray(
                chunk.transpose(3, 2, 1, 0),
                dtype=self.dtype.newbyteorder('<')).tobytes()
        else:
            import cv2
            x, y, z = chunk.shape[:3]
            img = np.ascontiguousarray(chunk[..., 0].transpose(2, 1, 0))
            ok, enc = cv2.imencode('.jpg', img.reshape(z * y, x),
                                   [cv2.IMWRITE_JPEG_QUALITY,
                                    int(self.scale.get('jpeg_quality',
                                                       _JPEG_QUALITY))])
            if not ok:
                raise ValueError(f'jpeg encoding of chunk {name} failed')
            data = enc.tobytes()
        _replace(os.path.join(self.dir, name), data)

    def read(self, box, txn=None):
        # x fastest, as the chunks hold the voxels
        out = np.zeros([b - a for a, b in box], self.dtype, order='F')
        for name, cell, part in self._cells(box):
            chunk = None
            if txn is not None:
                chunk = txn._chunk(self, name)
            if chunk is None:
                chunk = self.load(name, cell, part[2])
                cell = cell[:2] + [part[2]] + cell[3:]
            if chunk is None:
                continue
            out[tuple(slice(a - lo, b - lo) for (a, b), (lo, _)
                      in zip(part, box))] = \
                chunk[tuple(slice(a - lo, b - lo) for (a, b), (lo, _)
                            in zip(part, cell))]
        return out

    def write(self, box, data, txn=None):
        os.makedirs(self.dir, exist_ok=True)
        for name, cell, part in self._cells(box):
            src = data[tuple(slice(a - lo, b - lo) for (a, b), (lo, _)
                             in zip(part, box))]
            dst = tuple(slice(a - lo, b - lo) for (a, b), (lo, _)
                        in zip(part, cell))
            if txn is not None:
                chunk = txn._chunk(self, name)
                if chunk is None:
                    chunk = self._blank_or_loaded(name, cell, part)
                    txn._hold(self, name, chunk)
                chunk[dst] = src
                continue
            with _dir_lock(self.dir):
                chunk = self._blank_or_loaded(name, cell, part)
                chunk[dst] = src
                self.store(name, chunk)

    def _blank_or_loaded(self, name, cell, part):
        shape = [b - a for a, b in cell]
        if part != cell:
            old = self.load(name, cell)
            if old is not None:
                return np.array(old, order='F')
        return np.zeros(shape, self.dtype, order='F')


def _scale_from_spec(sm, dtype, nc):
    for k in ('size', 'resolution'):
        if k not in sm:
            raise UnsupportedSpec(f'scale_metadata.{k} is needed to create '
                                  'a scale without tensorstore')
    if 'chunk_size' not in sm:
        raise UnsupportedSpec('scale_metadata.chunk_size is needed to create '
                              'a scale without tensorstore (tensorstore '
                              'chooses one)')
    enc = sm.get('encoding', 'raw')
    if enc not in ('raw', 'jpeg'):
        raise UnsupportedSpec(f'precomputed encoding {enc!r}: only raw and '
                              'jpeg are served without tensorstore')
    if enc == 'jpeg' and (np.dtype(dtype) != np.uint8 or nc != 1):
        raise UnsupportedSpec('jpeg chunks are served for uint8 with one '
                              'channel only')
    res = [float(r) for r in sm['resolution']]
    sc = {'chunk_sizes': [[int(c) for c in sm['chunk_size']]],
          'encoding': enc, 'key': sm.get('key') or scale_key(res),
          'resolution': res, 'size': [int(s) for s in sm['size']],
          'voxel_offset': [int(v) for v in sm.get('voxel_offset',
                                                 (0, 0, 0))]}
    if enc == 'jpeg':
        sc['jpeg_quality'] = int(sm.get('jpeg_quality', _JPEG_QUALITY))
    return sc


def _check_scale(sc, sm):
    """Raise where ``sm`` (a spec's scale_metadata) disagrees with the
    stored scale ``sc``."""
    stored = dict(sc, chunk_size=sc['chunk_sizes'][0])
    for k in ('size', 'chunk_size', 'encoding', 'voxel_offset',
              'resolution', 'jpeg_quality'):
        if k in sm and sm[k] is not None:
            want, got = sm[k], stored.get(k)
            if k == 'resolution':
                same = np.allclose(np.asarray(want, float),
                                   np.asarray(got, float))
            else:
                same = want == got or (isinstance(want, (list, tuple))
                                       and list(want) == list(got or []))
            if not same:
                raise ValueError(f'FAILED_PRECONDITION: expected "{k}" of '
                                 f'{want} but received: {got}')


def _open_precomputed(spec):
    root = _file_path(spec['kvstore'])
    if spec.get('delete_existing'):
        raise UnsupportedSpec('delete_existing is not served without '
                              'tensorstore')
    chunk_layout = (spec.get('schema') or {}).get('chunk_layout') or {}
    rc = (chunk_layout.get('read_chunk') or {})
    wc = (chunk_layout.get('write_chunk') or {})
    rshape = rc.get('shape') or rc.get('shape_soft_constraint')
    wshape = wc.get('shape') or wc.get('shape_soft_constraint')
    sm = dict(spec.get('scale_metadata') or {})
    if sm.get('sharding') or (rshape and wshape
                              and list(rshape) != list(wshape)):
        raise UnsupportedSpec('the sharded precomputed format (read chunks '
                              'inside larger write shards) needs tensorstore')
    mm = dict(spec.get('multiscale_metadata') or {})
    create = bool(spec.get('create', False))
    may_open = bool(spec.get('open', not create))
    info_path = os.path.join(root, 'info')
    if create:
        os.makedirs(root, exist_ok=True)
    with _dir_lock(root) if create else nullcontext():
        info = None
        if os.path.exists(info_path):
            with builtins.open(info_path, 'rb') as f:
                info = json.loads(f.read())
        dtype = mm.get('data_type') or spec.get('dtype')
        if info is None:
            if not create:
                raise ValueError(f'NOT_FOUND: no precomputed volume at '
                                 f'{info_path}')
            if dtype is None:
                raise ValueError('multiscale_metadata.data_type is needed to '
                                 'create a volume')
            nc = int(mm.get('num_channels', 1))
            info = {'@type': 'neuroglancer_multiscale_volume',
                    'data_type': np.dtype(dtype).name, 'num_channels': nc,
                    'scales': [_scale_from_spec(sm, dtype, nc)],
                    'type': mm.get('type', 'image')}
            _replace(info_path, _info_bytes(info))
            return _Precomputed(root, info, 0)
        if any(sc.get('sharding') for sc in info['scales']):
            raise UnsupportedSpec(f'{info_path}: the sharded precomputed '
                                  'format needs tensorstore')
        for k, want in (('data_type', dtype),
                        ('num_channels', mm.get('num_channels')),
                        ('type', mm.get('type'))):
            if want is not None and (np.dtype(want).name if k == 'data_type'
                                     else want) != info.get(k):
                raise ValueError(f'FAILED_PRECONDITION: expected "{k}" of '
                                 f'{want} but received: {info.get(k)}')
        index = _find_scale(info, spec, sm)
        if index is None:
            if not create:
                raise ValueError(f'NOT_FOUND: no scale matching {sm} in '
                                 f'{info_path}')
            info['scales'].append(_scale_from_spec(
                sm, info['data_type'], int(info.get('num_channels', 1))))
            _replace(info_path, _info_bytes(info))
            return _Precomputed(root, info, len(info['scales']) - 1)
        if not may_open:
            raise ValueError(f'ALREADY_EXISTS: scale '
                             f'{info["scales"][index]["key"]} of {root}')
        _check_scale(info['scales'][index], sm)
        return _Precomputed(root, info, index)


def _find_scale(info, spec, sm):
    scales = info['scales']
    if spec.get('scale_index') is not None:
        i = int(spec['scale_index'])
        return i if i < len(scales) else None
    if sm.get('key'):
        return next((i for i, s in enumerate(scales)
                     if s['key'] == sm['key']), None)
    if sm.get('resolution') is not None:
        res = np.asarray(sm['resolution'], float)
        return next((i for i, s in enumerate(scales) if np.allclose(
            np.asarray(s['resolution'], float), res)), None)
    return 0 if scales else None


# ---------------------------------- views --------------------------------- #

def _reduce_blocks(a, pads, counts, f, method):
    """Reduce the C-ordered base block ``a`` over blocks of ``f``: ``pads``
    pad it to whole blocks, ``counts`` are the base voxels each output
    voxel covers per dimension."""
    nd = a.ndim
    inner = tuple(range(1, 2 * nd, 2))
    shape = [v for c, k in zip(counts, f) for v in (len(c), k)]
    if method in ('max', 'min'):
        if a.dtype.kind == 'f':
            fill = -np.inf if method == 'max' else np.inf
        else:
            info = np.iinfo(a.dtype)
            fill = info.min if method == 'max' else info.max
        ap = np.pad(a, pads, constant_values=fill).reshape(shape)
        return ap.max(axis=inner) if method == 'max' else ap.min(axis=inner)
    ap = np.pad(a, pads).reshape(shape)
    count = np.ones([len(c) for c in counts], np.int64)
    for d, c in enumerate(counts):
        count = count * c.reshape([-1 if e == d else 1 for e in range(nd)])
    if a.dtype.kind == 'f':
        # the type's own sum, one voxel of each block at a time
        blocks = ap.transpose(tuple(range(0, 2 * nd, 2)) + inner)
        flat = blocks.reshape(count.shape + (-1,))
        acc = np.zeros(count.shape, a.dtype)
        for i in range(flat.shape[-1]):
            acc += flat[..., i]
        return acc / count.astype(a.dtype)
    total = ap.sum(axis=inner, dtype=np.int64)
    q, r = np.divmod(total, count)
    # round half to even
    return q + ((2 * r > count) | ((2 * r == count) & (q % 2 == 1)))


class _Downsample:
    """A ``downsample`` view: each voxel reduces one block of its base."""

    def __init__(self, base, factors, method):
        if method not in ('mean', 'max', 'min'):
            raise UnsupportedSpec(f'downsample_method {method!r}: only mean, '
                                  'max and min are served without tensorstore')
        if len(factors) != len(base.lo):
            raise ValueError(f'downsample_factors {list(factors)} do not match '
                             f'the base rank {len(base.lo)}')
        self.base, self.f, self.method = base, [int(k) for k in factors], method
        self.dtype = base.dtype
        self.labels = base.labels
        self.lo = [lo // k for lo, k in zip(base.lo, self.f)]
        self.hi = [-(-hi // k) for hi, k in zip(base.hi, self.f)]
        # tensorstore's read chunk of the view
        self.chunk = [c // math.gcd(c, k) for c, k in zip(base.chunk, self.f)]

    def spec_json(self):
        return {'base': self.base.spec_json(), 'downsample_factors': self.f,
                'downsample_method': self.method, 'driver': 'downsample',
                'dtype': self.dtype.name}

    def read(self, box, txn=None):
        base_box = [(max(j0 * k, lo), min(j1 * k, hi)) for (j0, j1), k, lo, hi
                    in zip(box, self.f, self.base.lo, self.base.hi)]
        a = self.base.read(base_box, txn)
        pads = [(lo - j0 * k, j1 * k - hi)
                for (lo, hi), (j0, j1), k in zip(base_box, box, self.f)]
        counts = [np.minimum((np.arange(j0, j1) + 1) * k, hi)
                  - np.maximum(np.arange(j0, j1) * k, lo)
                  for (j0, j1), (lo, hi), k in zip(box, base_box, self.f)]
        if not a.flags.c_contiguous and a.T.flags.c_contiguous:
            # a stored volume arrives x fastest: reduce in that order
            out = _reduce_blocks(a.T, pads[::-1], counts[::-1], self.f[::-1],
                                 self.method).T
        else:
            out = _reduce_blocks(a, pads, counts, self.f, self.method)
        return out.astype(self.dtype, copy=False)

    def write(self, box, data, txn=None):
        raise ValueError('a downsample view is read-only')


class _Cast:
    """A ``cast`` view: the base's voxels converted to ``dtype``."""

    def __init__(self, base, dtype):
        self.base, self.dtype = base, np.dtype(dtype)
        self.lo, self.hi, self.chunk = base.lo, base.hi, base.chunk
        self.labels = base.labels

    def spec_json(self):
        return {'base': self.base.spec_json(), 'driver': 'cast',
                'dtype': self.dtype.name}

    def read(self, box, txn=None):
        return self.base.read(box, txn).astype(self.dtype)

    def write(self, box, data, txn=None):
        raise ValueError('a cast view is read-only here')


# ------------------------------- the store -------------------------------- #

class TensorStore:
    """A view of a volume or of a view over one. ``dims`` holds, for each
    dimension of the source, its kept range (lo, hi) or the integer it is
    indexed at (dropped from the view)."""

    def __init__(self, src, dims=None, txn=None):
        self._src = src
        self._dims = dims if dims is not None else \
            [(lo, hi) for lo, hi in zip(src.lo, src.hi)]
        self._txn = txn

    def _kept(self):
        return [(d, r) for d, r in enumerate(self._dims)
                if not isinstance(r, int)]

    @property
    def rank(self):
        return len(self._kept())

    @property
    def domain(self):
        return tuple(_Dim(lo, hi, self._src.labels[d])
                     for d, (lo, hi) in self._kept())

    @property
    def shape(self):
        return tuple(hi - lo for _, (lo, hi) in self._kept())

    @property
    def dtype(self):
        return _DType(self._src.dtype)

    @property
    def chunk_layout(self):
        return _ChunkLayout([self._src.chunk[d] for d, _ in self._kept()])

    def spec(self):
        return _Spec(self._src.spec_json())

    def with_transaction(self, txn):
        return TensorStore(self._src, list(self._dims), txn)

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        kept = self._kept()
        if sum(k is Ellipsis for k in key) > 1:
            raise IndexError('at most one ...')
        if Ellipsis in key:
            i = key.index(Ellipsis)
            key = key[:i] + (slice(None),) * (len(kept) - len(key) + 1) + \
                key[i + 1:]
        if len(key) > len(kept):
            raise IndexError(f'{len(key)} indices for rank {len(kept)}')
        dims = list(self._dims)
        for (d, (lo, hi)), k in zip(kept, key):
            if isinstance(k, (int, np.integer)) and not isinstance(k, bool):
                if not lo <= int(k) < hi:
                    raise IndexError(f'index {int(k)} outside [{lo}, {hi}) '
                                     f'of dimension {self._src.labels[d]}')
                dims[d] = int(k)
            elif isinstance(k, slice):
                if k.step not in (None, 1):
                    raise UnsupportedSpec('only unit-step slices are served '
                                          'without tensorstore')
                a = lo if k.start is None else int(k.start)
                b = hi if k.stop is None else int(k.stop)
                if not lo <= a <= b <= hi:
                    raise IndexError(f'slice [{a}, {b}) outside [{lo}, {hi}) '
                                     f'of dimension {self._src.labels[d]}')
                dims[d] = (a, b)
            else:
                raise UnsupportedSpec(f'index {k!r}: integers, unit-step '
                                      'slices and ... are served without '
                                      'tensorstore')
        return TensorStore(self._src, dims, self._txn)

    def _box(self):
        return [(r, r + 1) if isinstance(r, int) else r for r in self._dims]

    def read(self):
        arr = self._src.read(self._box(), self._txn)
        return _Future(arr[tuple(0 if isinstance(r, int) else slice(None)
                                 for r in self._dims)])

    def write(self, source):
        data = np.broadcast_to(np.asarray(source), self.shape).astype(
            self._src.dtype, copy=False)
        box = self._box()
        self._src.write(box, data.reshape([b - a for a, b in box]),
                        self._txn)
        return _Future()

    def __setitem__(self, key, source):
        self[key].write(source).result()


class Transaction:
    """Writes through ``store.with_transaction(txn)`` are held here, whole
    chunks at a time, and written at the commit."""

    def __init__(self):
        self._held = {}
        self.aborted = False
        self.commit_started = False

    def _chunk(self, src, name):
        held = self._held.get((src.dir, name))
        return None if held is None else held[1]

    def _hold(self, src, name, chunk):
        self._held[(src.dir, name)] = (src, chunk)

    def commit_async(self):
        """Write every held chunk; the returned future is done."""
        self.commit_started = True
        try:
            for (_, name), (src, chunk) in self._held.items():
                with _dir_lock(src.dir):
                    src.store(name, chunk)
        except BaseException:
            self.aborted = True
            raise
        self._held = {}
        return _Future()


def _source(spec):
    if not isinstance(spec, dict):
        raise UnsupportedSpec(f'spec {spec!r}: a JSON dict is needed')
    driver = spec.get('driver')
    if driver == 'neuroglancer_precomputed':
        return _open_precomputed(spec)
    if driver in ('downsample', 'cast'):
        base = _source(spec['base'])
        if driver == 'cast':
            return _Cast(base, spec['dtype'])
        return _Downsample(base, spec['downsample_factors'],
                           spec.get('downsample_method', 'stride'))
    if driver in ('zarr', 'zarr3', 'n5'):
        raise UnsupportedSpec(f'driver {driver!r} needs tensorstore: its '
                              'default compressor, blosc, is not served '
                              'here; write neuroglancer_precomputed instead')
    raise UnsupportedSpec(f'driver {driver!r} is not served without '
                          'tensorstore (neuroglancer_precomputed, downsample '
                          'and cast are)')


def open(spec):
    """Open ``spec`` (a tensorstore JSON spec); ``.result()`` gives the
    store."""
    return _Future(TensorStore(_source(spec)))
