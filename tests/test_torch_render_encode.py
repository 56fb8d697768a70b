"""The mesh renderer's card route writes a wave's output files side by side
(``common.imwrite_many`` on the process's decode pool): every file, the
fused mip levels and their metadata are byte-equal to the one-at-a-time
writes, the returned tiles keep their order, a failing write raises on
the caller with no write left running, the counters count what ran, and
a process that multiprocessing started stays serial."""

import multiprocessing
import os
import sys
import threading
import time
from concurrent import futures

import cv2
import numpy as np
import pytest
import torch

from feabas_tpu_torch import common, dal, storage, trace
from feabas_tpu_torch.dal import StreamLoader
from feabas_tpu_torch.mesh import Mesh
from feabas_tpu_torch.renderer import render_whole_mesh

# the tier-1 run shares the cores among several pytest workers
torch.set_num_threads(1)

WIDTH = 4
TILE = 48


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    trace.reset_counters()
    yield
    trace.reset_counters()


@pytest.fixture()
def pool(monkeypatch):
    """A fresh decode pool WIDTH threads wide, whatever the host's cores;
    shut down after the test."""
    monkeypatch.setattr(dal, '_cores', lambda: WIDTH)
    monkeypatch.setattr(dal, '_POOL', None)
    yield
    if dal._POOL is not None:
        dal._POOL.shutdown(wait=True)


def _world(n, seed=0):
    """A smooth uint8 texture with fine noise, so every tile's PNG holds
    content of its own."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    img = 120 + 60 * np.sin(x / 7.0) * np.cos(y / 11.0) \
        + rng.normal(0, 12, (n, n))
    return np.clip(img, 0, 255).astype(np.uint8)


def _warped_mesh(w, h):
    """A mesh over (0, 0, w, h) with its vertices moved a few px, so the
    render resamples."""
    m = Mesh.from_bbox((0, 0, w, h), cartesian=True, mesh_size=24)
    v = m.vertices('MOVING')
    m.set_vertices(v + np.stack([1.5 * np.sin(v[:, 1] / 13),
                                 1.5 * np.cos(v[:, 0] / 17)], -1), 'MOVING',
                   offset=m.offset('MOVING'))
    return m


def _render(root, rows, cols, mip_dirs=None, covered_cols=None):
    """render_whole_mesh on the card route (the CPU engine here) of a
    rows x cols canvas of TILE² tiles into root; the mesh covers the
    first ``covered_cols`` columns (all by default; a partial cover ends
    8 px short of its last column's edge), so the others render empty."""
    w = cols * TILE if covered_cols is None else covered_cols * TILE - 8
    mesh = _warped_mesh(w, rows * TILE)
    loader = StreamLoader(_world(max(rows, cols) * TILE + 8))
    return render_whole_mesh(
        mesh, loader, os.path.join(root, 'mip0', 's'), tile_size=(TILE, TILE),
        canvas_bbox=(0, 0, cols * TILE, rows * TILE), device_render=True,
        mip_dirs=mip_dirs, device='cpu')


def _metadata(tiles):
    """The lines the align CLI writes to a section's metadata.txt."""
    return ''.join(f'{storage.base_name(f)}\t{b[0]}\t{b[1]}\t{b[2]}\t{b[3]}\n'
                   for f, b in tiles.items())


def _files(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, 'rb') as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _serial_and_side_by_side(tmp_path, monkeypatch, **kw):
    """(tiles, files) rendered at width 1, then at WIDTH, and the
    counters of the second render."""
    monkeypatch.setattr(dal, '_cores', lambda: 1)
    ser = _render(str(tmp_path / 'serial'), **kw)
    monkeypatch.setattr(dal, '_cores', lambda: WIDTH)
    trace.reset_counters()
    par = _render(str(tmp_path / 'pooled'), **kw)
    return ((ser, _files(tmp_path / 'serial')),
            (par, _files(tmp_path / 'pooled')), trace.counters())


@pytest.mark.parametrize('rows, cols', [(1, 1), (1, 2), (2, 2), (2, 3)])
def test_a_waves_tiles_equal_the_serial_writes(tmp_path, pool, monkeypatch,
                                               rows, cols):
    (ser, ser_files), (par, par_files), c = _serial_and_side_by_side(
        tmp_path, monkeypatch, rows=rows, cols=cols)
    n = rows * cols
    assert len(ser_files) == n and ser_files == par_files
    assert [os.path.basename(f) for f in par] == \
        [os.path.basename(f) for f in ser]
    assert list(par.values()) == list(ser.values())
    assert _metadata(par).encode() == _metadata(ser).encode()
    assert c['blender.encodes'] == n
    assert c.get('render.encode_batches', 0) == (1 if n > 1 else 0)
    assert c.get('render.batched_encodes', 0) == (n if n > 1 else 0)
    assert (dal._POOL is None) == (n == 1)


def test_empty_tiles_are_left_out_in_order(tmp_path, pool, monkeypatch):
    (ser, ser_files), (par, par_files), c = _serial_and_side_by_side(
        tmp_path, monkeypatch, rows=2, cols=3, covered_cols=2)
    assert len(ser) == 4 and ser_files == par_files
    assert [os.path.basename(f) for f in par] == \
        [os.path.basename(f) for f in ser]
    assert list(par.values()) == list(ser.values())
    assert c['blender.encodes'] == c['render.batched_encodes'] == 4


@pytest.mark.parametrize('levels', [1, 2])
def test_fused_mip_levels_equal_the_serial_writes(tmp_path, pool,
                                                  monkeypatch, levels):
    def mip_dirs(root):
        return [str(root / f'mip{k}' / 's') for k in range(1, levels + 1)]
    monkeypatch.setattr(dal, '_cores', lambda: 1)
    ser = _render(str(tmp_path / 'serial'), 2, 2,
                  mip_dirs=mip_dirs(tmp_path / 'serial'))
    monkeypatch.setattr(dal, '_cores', lambda: WIDTH)
    trace.reset_counters()
    par = _render(str(tmp_path / 'pooled'), 2, 2,
                  mip_dirs=mip_dirs(tmp_path / 'pooled'))
    ser_files, par_files = (_files(tmp_path / 'serial'),
                            _files(tmp_path / 'pooled'))
    # four tiles at mip 0, four a level, and a level's metadata.txt
    assert len(ser_files) == 4 + levels * 5
    assert {k: v for k, v in par_files.items() if 'metadata' not in k} == \
        {k: v for k, v in ser_files.items() if 'metadata' not in k}
    for k in range(1, levels + 1):
        meta = os.path.join(f'mip{k}', 's', 'metadata.txt')
        want = ser_files[meta].replace(str(tmp_path / 'serial').encode(),
                                       str(tmp_path / 'pooled').encode())
        assert par_files[meta] == want
    assert [os.path.basename(f) for f in par] == \
        [os.path.basename(f) for f in ser]
    c = trace.counters()
    n = 4 * (1 + levels)
    assert c['blender.encodes'] == c['render.batched_encodes'] == n
    assert c['render.encode_batches'] == 1


def _items(tmp_path, n, seed=1):
    rng = np.random.default_rng(seed)
    return [(str(tmp_path / f'f{i}.png'),
             rng.integers(0, 256, (33, 47), np.uint8)) for i in range(n)]


@pytest.mark.parametrize('n', [1, 2, 4, 6])
def test_imwrite_many_writes_what_imwrite_writes(tmp_path, pool, n):
    items = _items(tmp_path / 'many', n)
    common.imwrite_many(items)
    for path, img in items:
        ref = str(tmp_path / 'one.png')
        common.imwrite(ref, img)
        with open(path, 'rb') as a, open(ref, 'rb') as b:
            assert a.read() == b.read()
    c = trace.counters()
    assert c['blender.encodes'] == 2 * n
    assert c.get('render.batched_encodes', 0) == (n if n > 1 else 0)


def _tracking(monkeypatch, delay):
    """Put a wrapper on ``common.imwrite`` that keeps the writes running at
    once (now, most) and the paths started; each write waits ``delay`` s
    first."""
    lock = threading.Lock()
    st = {'now': 0, 'most': 0, 'started': []}
    imwrite = common.imwrite

    def tracked(path, img, **kwargs):
        with lock:
            st['now'] += 1
            st['most'] = max(st['most'], st['now'])
            st['started'].append(os.path.basename(path))
        try:
            time.sleep(delay)
            return imwrite(path, img, **kwargs)
        finally:
            with lock:
                st['now'] -= 1
    monkeypatch.setattr(common, 'imwrite', tracked)
    return st


@pytest.mark.parametrize('bad', [0, 2])
@pytest.mark.parametrize('width', [1, WIDTH])
def test_a_failing_write_raises_on_the_caller_with_no_write_left(
        tmp_path, pool, monkeypatch, bad, width):
    """File ``bad`` goes under a regular file (its folder cannot be made):
    the caller's own write (0) or one on the pool (2)."""
    monkeypatch.setattr(dal, '_cores', lambda: width)
    items = _items(tmp_path, 6)
    (tmp_path / 'plain').write_bytes(b'')
    items[bad] = (str(tmp_path / 'plain' / 'x.png'), items[bad][1])
    st = _tracking(monkeypatch, 0.2)
    with pytest.raises(OSError):
        common.imwrite_many(items)
    assert st['now'] == 0
    if bad == 0:
        # the caller's write failed first: nothing after the first wave
        first = ['f1.png', 'f2.png', 'f3.png', 'x.png'] if width > 1 \
            else ['x.png']
        assert sorted(st['started']) == first
        assert not os.path.exists(items[4][0])
        assert not os.path.exists(items[5][0])
    else:
        assert os.path.exists(items[0][0])


def test_two_writes_are_in_flight_at_once(tmp_path, pool, monkeypatch):
    """Each write waits for a second one on a barrier: serial writes break
    it after its timeout, and the call raises instead of hanging."""
    barrier = threading.Barrier(2, timeout=5)
    imwrite = common.imwrite

    def waiting(path, img, **kwargs):
        barrier.wait()
        return imwrite(path, img, **kwargs)
    monkeypatch.setattr(common, 'imwrite', waiting)
    items = _items(tmp_path, 2)
    common.imwrite_many(items)
    for path, img in items:
        assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def test_no_more_writes_at_once_than_the_width(tmp_path, pool, monkeypatch):
    st = _tracking(monkeypatch, 0.05)
    items = _items(tmp_path, 11)
    common.imwrite_many(items)
    assert 2 <= st['most'] <= WIDTH
    assert sorted(st['started']) == sorted(os.path.basename(p)
                                           for p, _ in items)
    c = trace.counters()
    assert c['render.encode_batches'] == 1
    assert c['render.batched_encodes'] == c['blender.encodes'] == 11


def test_callers_on_many_threads_share_the_pool(tmp_path, pool):
    """Eight threads write five files each at once, switching threads every
    microsecond: every file is written as imwrite writes it, and no count
    is lost."""
    lists = [_items(tmp_path / f't{k}', 5, seed=k) for k in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with futures.ThreadPoolExecutor(8) as ex:
            list(ex.map(common.imwrite_many, lists, timeout=120))
    finally:
        sys.setswitchinterval(switch)
    for path, img in (it for items in lists for it in items):
        assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    c = trace.counters()
    assert c['render.encode_batches'] == 8
    assert c['render.batched_encodes'] == c['blender.encodes'] == 40


def _write_in_worker(items):
    trace.reset_counters()
    common.imwrite_many(items)
    return trace.counters(), dal._POOL is None


def test_a_process_multiprocessing_started_writes_serially(tmp_path):
    items = _items(tmp_path, 4)
    ctx = multiprocessing.get_context('spawn')
    with futures.ProcessPoolExecutor(1, mp_context=ctx) as ex:
        c, no_pool = ex.submit(_write_in_worker, items).result(timeout=120)
    for path, img in items:
        assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    assert c['blender.encodes'] == 4
    assert 'render.encode_batches' not in c and no_pool
