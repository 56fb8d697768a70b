"""The port's precomputed store (``feabas_tpu_torch._tslite``) against
tensorstore on the same specs: the same ``info`` and chunk files, volumes
written by either read back by the other, the same downsample and cast
views, and an error naming what is missing for every spec it does not
serve."""

import os

import numpy as np
import pytest
import tensorstore as ts

from feabas_tpu_torch import _tslite

BACKENDS = {'tensorstore': ts, '_tslite': _tslite}


def _spec(path, size, chunk, dtype='uint8', encoding='raw',
          resolution=(4, 4, 30), nc=1, **sm):
    return {'driver': 'neuroglancer_precomputed',
            'kvstore': {'driver': 'file', 'path': str(path)},
            'scale_metadata': dict(size=list(size), chunk_size=list(chunk),
                                   resolution=list(resolution),
                                   encoding=encoding, **sm),
            'multiscale_metadata': {'data_type': dtype, 'num_channels': nc,
                                    'type': 'image'},
            'create': True, 'open': True}


def _volume(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == 'f':
        return (rng.random(shape) * rng.choice([1e-3, 1.0, 1e4], shape)
                ).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, shape).astype(dtype)


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, 'rb') as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize('dtype', ['uint8', 'uint16', 'float32'])
@pytest.mark.parametrize('resolution', [(4, 4, 30), (4.5, 4, 30),
                                        (4.123456789, 1e7, 0.25)])
def test_info_and_chunk_files_equal_tensorstores(tmp_path, dtype, resolution):
    """Created and written by each: the same info (key by key and byte for
    byte) and the same chunk file names and bytes, edge chunks clipped."""
    size, chunk = (100, 70, 5), (64, 64, 2)
    vol = _volume(size + (1,), dtype, 0)
    for name, mod in BACKENDS.items():
        d = mod.open(_spec(tmp_path / name, size, chunk, dtype,
                           resolution=resolution)).result()
        d[...] = vol
    a, b = _files(tmp_path / 'tensorstore'), _files(tmp_path / '_tslite')
    assert sorted(a) == sorted(b)
    key = _tslite.scale_key(resolution)
    assert f'{key}/64-100_0-64_4-5' in a
    import json
    assert json.loads(a['info']) == json.loads(b['info'])
    for k in a:
        assert a[k] == b[k], k


@pytest.mark.parametrize('dtype', ['uint8', 'uint16', 'float32'])
@pytest.mark.parametrize('rank', [3, 4])
@pytest.mark.parametrize('writer', ['tensorstore', '_tslite'])
def test_raw_volumes_read_back_by_the_other(tmp_path, dtype, rank, writer):
    """A raw volume at a size that is no multiple of its chunk, written by
    one (in parts: whole chunks, part chunks, one z layer) and read by
    the other, bit for bit; reads through a rank-3 view of the z layer."""
    reader = '_tslite' if writer == 'tensorstore' else 'tensorstore'
    size, chunk = (90, 77, 7), (32, 24, 3)
    spec = _spec(tmp_path / 'v', size, chunk, dtype)
    want = _volume(size, dtype, 1)
    w = BACKENDS[writer].open(spec).result()
    if rank == 4:
        w[0:50, 0:77, 0:7, 0] = want[0:50]
        w[50:90, 10:77, :, 0] = want[50:90, 10:77]
        w[50:90, 0:10, 3, 0] = want[50:90, 0:10, 3]
    else:
        w = w[..., 0]
        w[0:50] = want[0:50]
        w[50:90, 10:77, :] = want[50:90, 10:77]
        w[50:90, 0:10, 3] = want[50:90, 0:10, 3]
    want[50:90, 0:10, [0, 1, 2, 4, 5, 6]] = 0   # never written
    r = BACKENDS[reader].open({'driver': 'neuroglancer_precomputed',
                               'kvstore': {'driver': 'file',
                                           'path': str(tmp_path / 'v')}}
                              ).result()
    assert r.rank == 4 and tuple(r.shape) == size + (1,)
    assert r.dtype.name == dtype
    assert tuple(r.chunk_layout.read_chunk.shape) == chunk + (1,)
    got = r[...].read().result()
    assert got.dtype == np.dtype(dtype)
    assert np.array_equal(got[..., 0], want)
    assert np.array_equal(r[13:71, 5:60, 4, 0].read().result(),
                          want[13:71, 5:60, 4])
    dom = r.domain
    assert [(dom[i].inclusive_min, dom[i].exclusive_max) for i in range(4)] \
        == [(0, 90), (0, 77), (0, 7), (0, 1)]


@pytest.mark.parametrize('writer', ['tensorstore', '_tslite'])
def test_jpeg_both_ways_within_one_lsb(tmp_path, writer):
    """A jpeg volume written by either: each reader's decode of the other's
    chunks is within 1 LSB of tensorstore's own decode of them."""
    size, chunk = (128, 96, 4), (64, 48, 2)
    rng = np.random.default_rng(2)
    img = np.clip(rng.normal(128, 30, size).astype(np.float32)
                  .cumsum(0) / 4, 0, 255).astype(np.uint8)
    BACKENDS[writer].open(_spec(tmp_path / 'j', size, chunk,
                                encoding='jpeg')).result()[..., 0] = img
    base = {'driver': 'neuroglancer_precomputed',
            'kvstore': {'driver': 'file', 'path': str(tmp_path / 'j')}}
    by_ts = ts.open(base).result()[..., 0].read().result()
    by_lite = _tslite.open(base).result()[..., 0].read().result()
    assert np.abs(by_ts.astype(int) - by_lite.astype(int)).max() <= 1
    assert np.abs(by_ts.astype(int) - img.astype(int)).mean() < 8
    info = _tslite.open(base).result().spec().to_json()['scale_metadata']
    assert info['encoding'] == 'jpeg' and info['jpeg_quality'] == 75


def _mean_tol(dtype, factors):
    """Float means sum in float32 in block order: tensorstore and this store
    may order a block's sum differently, each within n ulps of the exact
    mean of n voxels."""
    if np.dtype(dtype).kind != 'f':
        return 0.0
    return 2.0 * np.prod(factors) * np.finfo(np.float32).eps


@pytest.mark.parametrize('dtype', ['uint8', 'uint16', 'int16', 'float32'])
@pytest.mark.parametrize('method', ['mean', 'max', 'min'])
@pytest.mark.parametrize('factors', [[2, 2, 1, 1], [8, 8, 1, 1],
                                     [4, 4, 3, 1]])
def test_downsample_equals_tensorstores(tmp_path, dtype, method, factors):
    """The downsample view over a volume that no factor divides, read whole
    and in a part, equal to tensorstore's bit for bit (float means: within
    their sum-order bound); a stacked view and a cast over it too."""
    size, chunk = (45, 37, 7), (16, 16, 2)
    vol = _volume(size + (1,), dtype, 3)
    ts.open(_spec(tmp_path / 'v', size, chunk, dtype)).result()[...] = vol
    base = {'driver': 'neuroglancer_precomputed',
            'kvstore': {'driver': 'file', 'path': str(tmp_path / 'v')}}
    ds = {'driver': 'downsample', 'downsample_factors': factors,
          'downsample_method': method, 'base': base}
    stacked = {'driver': 'cast', 'dtype': 'float32',
               'base': {'driver': 'downsample',
                        'downsample_factors': [2, 2, 1, 1],
                        'downsample_method': 'mean', 'base': ds}}
    tol = _mean_tol(dtype, factors) if method == 'mean' else 0.0
    for spec, tol in ((ds, tol),
                      (stacked, tol + _mean_tol(dtype, [2, 2, 1, 1]))):
        a = ts.open(spec).result()
        b = _tslite.open(spec).result()
        assert tuple(a.shape) == tuple(b.shape)
        assert a.dtype.name == b.dtype.name
        assert tuple(a.chunk_layout.read_chunk.shape) == \
            tuple(b.chunk_layout.read_chunk.shape)
        for view in (lambda d: d[...], lambda d: d[1:, 2:, 1, 0]):
            x = view(a).read().result()
            y = view(b).read().result()
            assert x.dtype == y.dtype and x.shape == y.shape
            if tol:
                np.testing.assert_allclose(y, x, rtol=tol, atol=0)
            else:
                assert np.array_equal(x, y)


def test_integer_mean_rounds_half_to_even(tmp_path):
    """uint8 means as tensorstore rounds them: [1, 2] -> 2, [2, 3] -> 2,
    [3, 4] -> 4, [0, 1] -> 0, and [1, 2, 3, 9, 9] by 2 -> [2, 6, 9] (the
    edge block averages the one voxel there)."""
    rows = [[1, 2], [2, 3], [3, 4], [0, 1], [1, 2, 3, 9, 9]]
    want = [[2], [2], [4], [0], [2, 6, 9]]
    for k, (row, w) in enumerate(zip(rows, want)):
        path = tmp_path / f'r{k}'
        _tslite.open(_spec(path, (len(row), 1, 1), (8, 1, 1))).result()[
            :, 0, 0, 0] = np.asarray(row, np.uint8)
        for mod in BACKENDS.values():
            got = mod.open({'driver': 'downsample',
                            'downsample_factors': [2, 1, 1, 1],
                            'downsample_method': 'mean',
                            'base': {'driver': 'neuroglancer_precomputed',
                                     'kvstore': {'driver': 'file',
                                                 'path': str(path)}}}
                           ).result()[:, 0, 0, 0].read().result()
            assert got.tolist() == w, (mod.__name__, row)


def test_missing_partial_transaction_and_appended_scale(tmp_path):
    """A chunk never written reads 0; a write into part of a chunk keeps the
    rest; writes through a transaction land at its commit; a new key opened
    with create + open is appended to the info that tensorstore reads."""
    spec = _spec(tmp_path / 'v', (40, 30, 4), (16, 16, 4))
    d = _tslite.open(spec).result()
    assert not d[...].read().result().any()
    d[0:16, 0:16, 0:4, 0] = 9
    d[4:8, 4:8, 2, 0] = 3               # one z layer of a 4-deep chunk
    got = d[0:16, 0:16, :, 0].read().result()
    assert (got[4:8, 4:8, 2] == 3).all() and (got[4:8, 4:8, 1] == 9).all()
    assert (got == 9).sum() == 16 * 16 * 4 - 16
    txn = _tslite.Transaction()
    fut = d.with_transaction(txn)[20:40, 0:30, 1, 0].write(
        np.full((20, 30), 5, np.uint8))
    fut.result()
    assert not d[20:40, :, 1, 0].read().result().any()
    txn.commit_async().result(timeout=5)
    assert not txn.aborted
    assert (ts.open(dict(spec, create=False)).result()[20:40, :, 1, 0]
            .read().result() == 5).all()
    half = _spec(tmp_path / 'v', (20, 15, 4), (16, 16, 4),
                 resolution=(8, 8, 30))
    _tslite.open(half).result()[...] = 1
    a = ts.open(half).result()
    assert a.spec().to_json()['scale_metadata']['key'] == '8_8_30'
    assert (a.read().result() == 1).all()
    assert (ts.open(spec).result()[0:16, 0:16, 0, 0].read().result()
            == 9).all()
    import json
    with open(tmp_path / 'v' / 'info') as f:
        assert [s['key'] for s in json.load(f)['scales']] == \
            ['4_4_30', '8_8_30']
    with pytest.raises(ValueError, match='size'):
        _tslite.open(_spec(tmp_path / 'v', (21, 15, 4), (16, 16, 4),
                           resolution=(8, 8, 30))).result()


@pytest.mark.parametrize('spec, missing', [
    ({'driver': 'zarr', 'kvstore': {'driver': 'file', 'path': 'x'}},
     'blosc'),
    ({'driver': 'n5', 'kvstore': {'driver': 'file', 'path': 'x'}}, 'blosc'),
    (dict(_spec('x', (8, 8, 2), (8, 8, 2)), schema={'chunk_layout': {
        'read_chunk': {'shape_soft_constraint': [4, 4, 2, 1]},
        'write_chunk': {'shape_soft_constraint': [8, 8, 2, 1]}}}),
     'sharded'),
    ({'driver': 'neuroglancer_precomputed',
      'kvstore': {'driver': 'gcs', 'bucket': 'b', 'path': 'x'}}, 'gcs'),
])
def test_refusals_name_what_is_missing(spec, missing, tmp_path):
    with pytest.raises(_tslite.UnsupportedSpec, match=missing):
        _tslite.open(spec).result()
