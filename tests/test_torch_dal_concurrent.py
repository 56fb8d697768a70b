"""A multi-tile crop of ``dal.StaticImageLoader`` decodes its uncached tiles
side by side on the process's decode pool and pastes them in the file
index's order on the calling thread: the crop is byte-equal to a
one-tile-at-a-time paste, a read's exception reaches the caller, the
counters count what ran, and a process that multiprocessing started stays
serial."""

import multiprocessing
import re
import sys
import threading
from concurrent import futures

import cv2
import numpy as np
import pytest

from feabas_tpu_torch import common, dal, trace

WIDTH = 4


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


def _grid(tmp_path, rows, cols, th=40, tw=56, step=None, short=None, seed=0):
    """Tiles of random uint8 on a rows x cols grid, ``step`` px apart (less
    than the tile: overlapping tiles of other content); ``short`` cuts
    the last tile's image to (h, w) under its recorded bbox."""
    step = step or (th, tw)
    rng = np.random.default_rng(seed)
    paths, bboxes = [], []
    for r in range(rows):
        for c in range(cols):
            img = rng.integers(0, 256, (th, tw), np.uint8)
            if short is not None and (r, c) == (rows - 1, cols - 1):
                img = img[:short[0], :short[1]]
            p = str(tmp_path / f't_{r}_{c}.png')
            assert cv2.imwrite(p, img)
            x0, y0 = c * step[1] + 3, r * step[0] + 5
            paths.append(p)
            bboxes.append((x0, y0, x0 + tw, y0 + th))
    return paths, bboxes


def _serial(loader, bbox, fillval=0):
    """The crop one tile at a time: each tile the index finds, read whole
    with cv2, its part inside bbox pasted over the earlier ones."""
    x0, y0 = int(round(bbox[0])), int(round(bbox[1]))
    w, h = int(round(bbox[2] - bbox[0])), int(round(bbox[3] - bbox[1]))
    out = np.full((h, w), fillval, np.uint8)
    filled = False
    for fid in loader.file_index.query(bbox):
        img = cv2.imread(loader.imgpaths[fid], cv2.IMREAD_UNCHANGED)
        tb = [int(round(v)) for v in loader.bboxes[fid]]
        cx0, cy0 = max(x0, tb[0]), max(y0, tb[1])
        cx1 = min(x0 + w, tb[2], tb[0] + img.shape[1])
        cy1 = min(y0 + h, tb[3], tb[1] + img.shape[0])
        if cx0 < cx1 and cy0 < cy1:
            out[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0] = \
                img[cy0 - tb[1]:cy1 - tb[1], cx0 - tb[0]:cx1 - tb[0]]
            filled = True
    return out, filled


# name: (rows, cols, step, short, bbox)
CASES = {
    '2x2': (2, 2, None, None, (0, 0, 120, 90)),
    '3x3': (3, 3, None, None, (10, 12, 160, 118)),
    'overlapping': (3, 3, (30, 40), None, (0, 0, 130, 100)),
    'ragged_edge': (2, 2, None, (25, 33), (0, 0, 120, 90)),
    'float_bbox': (2, 2, None, None, (10.5, 7.25, 139.0, 80.75)),
}


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('margin', [0, 6])
def test_pooled_crops_equal_the_serial_paste(tmp_path, pool, case, margin):
    rows, cols, step, short, bbox = CASES[case]
    paths, bboxes = _grid(tmp_path, rows, cols, step=step, short=short)
    loader = dal.StaticImageLoader(paths, bboxes, fillval=7, cache_size=64,
                                   cache_border_margin=margin)
    want, _ = _serial(loader, bbox, fillval=7)
    n = len(loader.file_index.query(bbox))
    got = loader.crop(bbox)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    c = trace.counters()
    assert c['loader.decode_batches'] == 1
    assert c['loader.batched_decodes'] == c['loader.decodes'] == n
    # again: the cache serves every tile (whole images, or with border
    # bands, an interior crop decodes again)
    got = loader.crop(bbox)
    assert np.array_equal(got, want)
    again = trace.counters()
    assert again['loader.decodes'] == (n if margin == 0 else 2 * n)
    assert again['loader.decode_batches'] == (1 if margin == 0 else 2)


@pytest.mark.parametrize('margin', [0, 6])
def test_only_the_tiles_the_cache_lacks_go_to_the_pool(tmp_path, pool, margin):
    paths, bboxes = _grid(tmp_path, 3, 3)
    loader = dal.StaticImageLoader(paths, bboxes, cache_size=64,
                                   cache_border_margin=margin)
    # seed the cache with tile 4 (its border bands cover this strip)
    loader.crop((bboxes[4][0], bboxes[4][1], bboxes[4][2], bboxes[4][1] + 3),
                fileid=4)
    trace.reset_counters()
    bbox = (bboxes[0][0] + 50, bboxes[0][1] + 38,
            bboxes[8][0] + 4, bboxes[4][1] + 2)
    want, _ = _serial(loader, bbox)
    hits = list(loader.file_index.query(bbox))
    assert 4 in hits and len(hits) >= 3
    assert np.array_equal(loader.crop(bbox), want)
    c = trace.counters()
    assert c['loader.cache_hits'] == (1 if margin == 0 else 4)
    assert c['loader.batched_decodes'] == c['loader.decodes'] == len(hits) - 1
    assert c['loader.decode_batches'] == 1


@pytest.mark.parametrize('bbox, empty', [
    ((500, 500, 600, 560), True),          # no tile
    ((90, 70, 112, 90), True),             # only the short tile's missing part
    ((0, 0, 120, 90), False),
])
@pytest.mark.parametrize('margin', [0, 6])
def test_return_empty_as_the_serial_paste(tmp_path, pool, bbox, empty, margin):
    paths, bboxes = _grid(tmp_path, 2, 2, short=(20, 30))
    loader = dal.StaticImageLoader(paths, bboxes, cache_border_margin=margin)
    want, filled = _serial(loader, bbox)
    assert filled == (not empty)
    got = loader.crop(bbox, return_empty=True)
    if empty:
        assert got is None
        assert np.array_equal(loader.crop(bbox), want)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize('width', [1, WIDTH])
def test_a_failing_read_raises_what_the_serial_read_raises(
        tmp_path, pool, monkeypatch, width):
    monkeypatch.setattr(dal, '_cores', lambda: width)
    paths, bboxes = _grid(tmp_path, 2, 2)
    with open(paths[2], 'wb') as f:
        f.write(b'not an image')
    loader = dal.StaticImageLoader(paths, bboxes, dtype='uint8',
                                   number_of_channels=1)
    with pytest.raises(RuntimeError,
                       match=re.escape(f'failed to read {paths[2]}')):
        loader.crop((0, 0, 120, 90))
    assert trace.counters().get('loader.decode_batches', 0) == \
        (1 if width > 1 else 0)


def test_two_reads_are_in_flight_at_once(tmp_path, pool, monkeypatch):
    """Each decode waits for a second one on a barrier: serial decodes
    break it after its timeout, and the crop raises instead of hanging."""
    paths, bboxes = _grid(tmp_path, 1, 2)
    loader = dal.StaticImageLoader(paths, bboxes)
    barrier = threading.Barrier(2, timeout=5)
    imread = common.imread

    def waiting(path, **kwargs):
        barrier.wait()
        return imread(path, **kwargs)
    monkeypatch.setattr(common, 'imread', waiting)
    bbox = (0, 0, 120, 50)
    assert np.array_equal(loader.crop(bbox), _serial(loader, bbox)[0])
    assert trace.counters()['loader.batched_decodes'] == 2


def test_no_more_reads_in_flight_than_the_width(tmp_path, pool, monkeypatch):
    """Crops of a 3 x 3 grid from eight threads at once (a threaded
    fan-out), switching threads every microsecond, share the one pool:
    never more decodes at once than its threads, and no count lost."""
    paths, bboxes = _grid(tmp_path, 3, 3)
    lock = threading.Lock()
    now, most = [0], [0]
    imread = common.imread

    def counting(path, **kwargs):
        with lock:
            now[0] += 1
            most[0] = max(most[0], now[0])
        try:
            return imread(path, **kwargs)
        finally:
            with lock:
                now[0] -= 1
    monkeypatch.setattr(common, 'imread', counting)
    bbox = (0, 0, 170, 125)
    loaders = [dal.StaticImageLoader(paths, bboxes) for _ in range(8)]
    want = _serial(loaders[0], bbox)[0]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with futures.ThreadPoolExecutor(8) as ex:
            got = list(ex.map(lambda ld: ld.crop(bbox), loaders, timeout=120))
    finally:
        sys.setswitchinterval(switch)
    assert all(np.array_equal(g, want) for g in got)
    assert 2 <= most[0] <= WIDTH
    c = trace.counters()
    assert c['loader.decode_batches'] == 8
    assert c['loader.batched_decodes'] == c['loader.decodes'] == 8 * 9


@pytest.mark.parametrize('bbox', [(0, 0, 40, 30), (60, 45, 100, 80)])
def test_single_tile_and_fileid_crops_stay_in_line(tmp_path, pool, bbox):
    paths, bboxes = _grid(tmp_path, 2, 2)
    loader = dal.StaticImageLoader(paths, bboxes)
    assert np.array_equal(loader.crop(bbox), _serial(loader, bbox)[0])
    loader.crop((0, 0, 120, 90), fileid=1)
    c = trace.counters()
    assert c['loader.decodes'] == 2
    assert 'loader.decode_batches' not in c and dal._POOL is None


def _crop_in_worker(paths, bboxes, bbox):
    trace.reset_counters()
    loader = dal.StaticImageLoader(paths, bboxes)
    return loader.crop(bbox), trace.counters(), dal._POOL is None


def test_a_process_multiprocessing_started_crops_serially(tmp_path):
    paths, bboxes = _grid(tmp_path, 2, 2)
    bbox = (0, 0, 120, 90)
    ctx = multiprocessing.get_context('spawn')
    with futures.ProcessPoolExecutor(1, mp_context=ctx) as ex:
        got, c, no_pool = ex.submit(_crop_in_worker, paths, bboxes,
                                    bbox).result(timeout=120)
    loader = dal.StaticImageLoader(paths, bboxes)
    assert np.array_equal(got, _serial(loader, bbox)[0])
    assert c['loader.decodes'] == 4
    assert 'loader.decode_batches' not in c and no_pool
