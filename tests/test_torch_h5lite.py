"""The port's minimal HDF5 writer/reader against h5py."""

import h5py
import numpy as np
import pytest

from feabas_tpu_torch import _h5lite


DATA = {
    'a/b/f64': np.arange(10, dtype=np.float64).reshape(5, 2) / 3,
    'a/i32': np.arange(12, dtype=np.int32).reshape(3, 4),
    'i16': np.arange(-3, 3, dtype=np.int16),
    'u8': np.frombuffer(b'tile_000.png', np.uint8).copy(),
    'f32': np.float32([1.5, -2.25]),
    'scalar_f': 3.5,
    'scalar_i': 7,
    'flag_t': True,
    'flag_f': np.bool_(False),
    'empty': np.zeros((0, 2)),
    'meshes/0/vertices': np.ones((3, 2)),
    'meshes/10/vertices': np.zeros((2, 2)),
}


def _same(a, b):
    return (type(a) is type(b) and np.asarray(a).dtype == np.asarray(b).dtype
            and np.array_equal(a, b))


def test_h5lite_writes_what_h5py_reads(tmp_path):
    path = str(tmp_path / 'lite.h5')
    with _h5lite.File(path, 'w') as f:
        for k, v in DATA.items():
            f.create_dataset(k, data=v, compression='gzip')
    with h5py.File(path, 'r') as f, _h5lite.File(path, 'r') as g:
        assert sorted(f.keys()) == g.keys()
        assert sorted(f['meshes'].keys()) == g['meshes'].keys() == ['0', '10']
        for k, v in DATA.items():
            assert _same(g[k][()], f[k][()]), k
            assert np.array_equal(g[k][()], np.asarray(v)), k
        assert 'a/b' in g and 'zz' not in g


def test_h5lite_reads_h5py_latest_files(tmp_path):
    path = str(tmp_path / 'ref.h5')
    keys = ['a/b/f64', 'i16', 'scalar_f', 'flag_t', 'u8']
    with h5py.File(path, 'w', libver='latest') as f:
        for k in keys:
            f.create_dataset(k, data=DATA[k])
    with h5py.File(path, 'r') as f, _h5lite.File(path, 'r') as g:
        for k in keys:
            assert _same(g[k][()], f[k][()]), k


def test_h5lite_refuses_what_it_cannot_read(tmp_path):
    path = str(tmp_path / 'v0.h5')
    with h5py.File(path, 'w') as f:          # superblock v0 (libver earliest)
        f.create_dataset('x', data=np.arange(3))
    with pytest.raises(OSError):
        _h5lite.File(path, 'r')


def test_stitcher_h5_round_trip_through_h5lite(tmp_path, monkeypatch):
    """The match/tform H5 files the stitch path writes, through the
    stand-in, read back equal with h5py."""
    from feabas_tpu_torch import storage
    from feabas_tpu_torch.common import Match
    from feabas_tpu_torch.stitcher import Stitcher
    rng = np.random.default_rng(0)
    st = Stitcher([f't{k}.png' for k in range(3)],
                  [(0, 0, 200, 160), (150, 0, 350, 160), (300, 2, 500, 162)],
                  root_dir='/x', resolution=4, name='s1', device='cpu')
    st.matches[(0, 1)] = Match(rng.random((5, 2)), rng.random((5, 2)),
                               rng.random(5), 0.01)
    st.initialize_meshes()
    ref = str(tmp_path / 'ref.h5')
    st.save_to_h5(ref)
    lite = str(tmp_path / 'lite.h5')
    monkeypatch.setattr(storage, 'h5py', _h5lite)
    st.save_to_h5(lite)
    back_lite = Stitcher.from_h5(lite, device='cpu')
    monkeypatch.undo()
    back = Stitcher.from_h5(lite, device='cpu')       # h5py reads it
    want = Stitcher.from_h5(ref, device='cpu')
    for got in (back, back_lite):
        assert got.imgpaths == want.imgpaths and got.name == 's1'
        assert np.array_equal(got.matches[(0, 1)].xy0, want.matches[(0, 1)].xy0)
        for m, w in zip(got.meshes, want.meshes):
            assert np.array_equal(m.triangles, w.triangles)
            assert np.array_equal(m.vertices_w_offset('FIXED'),
                                  w.vertices_w_offset('FIXED'))
            assert m.locked == w.locked and m.uid == w.uid
