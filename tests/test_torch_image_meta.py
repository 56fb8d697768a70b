"""An image file's dtype, channels and size from its header
(``common.image_meta``): the image loaders learn what a whole decode of the
first tile would tell them, and decode only where the header does not
settle it."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from feabas_tpu_torch import common, dal, trace


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    trace.reset_counters()
    yield
    trace.reset_counters()


def _chunk(kind, data):
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data)))


def _png(path, h, w, depth, ctype, extra=(), seed=0):
    """A PNG written byte by byte: random samples, unfiltered rows, the
    chunks of ``extra`` between IHDR and IDAT."""
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rowbytes = (w * samples * depth + 7) // 8
    rows = np.random.default_rng(seed).integers(0, 256, (h, rowbytes), np.uint8)
    if ctype == 3:      # palette indices within a 2-entry palette
        rows &= np.uint8(0x55 if depth == 2 else 0x11 if depth == 4
                         else 0x01 if depth == 8 else 0xff)
    raw = b''.join(b'\x00' + r.tobytes() for r in rows)
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, ctype,
                                              0, 0, 0))
                + b''.join(_chunk(k, d) for k, d in extra)
                + _chunk(b'IDAT', zlib.compress(raw))
                + _chunk(b'IEND', b''))


def _cv2_file(path, shape, dtype, seed=0):
    info = np.iinfo(dtype)
    img = np.random.default_rng(seed).integers(
        0, int(info.max) + 1, shape).astype(dtype)
    assert cv2.imwrite(path, img)


H, W = 37, 53
# kind: (file name, writer, read from the header)
KINDS = {
    'grey1': ('t.png', lambda p: _png(p, H, W, 1, 0), True),
    'grey8': ('t.png', lambda p: _cv2_file(p, (H, W), np.uint8), True),
    'grey16': ('t.png', lambda p: _cv2_file(p, (H, W), np.uint16), True),
    'bgr8': ('t.png', lambda p: _cv2_file(p, (H, W, 3), np.uint8), True),
    'bgr16': ('t.png', lambda p: _cv2_file(p, (H, W, 3), np.uint16), True),
    'bgra8': ('t.png', lambda p: _cv2_file(p, (H, W, 4), np.uint8), True),
    'grey_alpha8': ('t.png', lambda p: _png(p, H, W, 8, 4), True),
    'grey_alpha16': ('t.png', lambda p: _png(p, H, W, 16, 4), True),
    'palette': ('t.png', lambda p: _png(
        p, H, W, 8, 3, [(b'PLTE', bytes([0, 0, 0, 255, 255, 255]))]), False),
    'bgr8_trns': ('t.png', lambda p: _png(
        p, H, W, 8, 2, [(b'tRNS', bytes(6))]), False),
    'jpeg': ('t.jpg', lambda p: _cv2_file(p, (H, W), np.uint8), False),
    'tiff': ('t.tif', lambda p: _cv2_file(p, (H, W), np.uint16), False),
}


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_a_loader_learns_what_a_decode_of_its_first_tile_gives(tmp_path, kind):
    """The loader's dtype and channels, and ``from_filepath``'s tile size,
    equal what ``cv2.imread(..., IMREAD_UNCHANGED)`` gives, for every file
    kind; the header answers for PNGs of every colour type but palette and
    with no tRNS chunk, a whole decode for the rest."""
    name, write, by_header = KINDS[kind]
    stem, ext = os.path.splitext(name)
    path = str(tmp_path / f'{stem}_tr0-tc0{ext}')
    write(path)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ref is not None
    want = (ref.shape[0], ref.shape[1], ref.dtype.name,
            1 if ref.ndim == 2 else ref.shape[-1])

    meta = common.image_meta(path)
    assert meta == (want if by_header else None)
    trace.reset_counters()
    loader = dal.StaticImageLoader([path], [(0, 0, W, H)])
    assert (loader.dtype, loader.number_of_channels) == want[2:]
    c = trace.counters()
    if by_header:
        assert c.get('loader.meta_headers') == 1
        assert 'loader.decodes' not in c and 'loader.meta_decodes' not in c
    else:
        assert c.get('loader.meta_decodes') == 1 == c.get('loader.decodes')
        assert 'loader.meta_headers' not in c

    trace.reset_counters()
    tiled = dal.StaticImageLoader.from_filepath([path])
    x0, y0, x1, y1 = tiled.bboxes[0]
    assert (y1 - y0, x1 - x0) == want[:2]
    assert (tiled.dtype, tiled.number_of_channels) == want[2:]
    c = trace.counters()
    # the tile size and the loader's probe: two reads of the same file
    key = 'loader.meta_headers' if by_header else 'loader.meta_decodes'
    assert c.get(key) == 2


@pytest.mark.parametrize('fault', ['signature', 'ihdr_crc', 'ihdr_length',
                                   'bad_depth', 'no_idat', 'missing',
                                   'cloud'])
def test_a_header_that_does_not_settle_the_decode_reads_none(tmp_path, fault):
    path = str(tmp_path / 't.png')
    _cv2_file(path, (H, W), np.uint8)
    with open(path, 'rb') as f:
        data = bytearray(f.read())
    if fault == 'signature':
        data[1:4] = b'JPG'
    elif fault == 'ihdr_crc':
        data[16] ^= 1               # the width, under the old CRC
    elif fault == 'ihdr_length':
        data[11] = 12
    elif fault == 'bad_depth':      # RGB at 4 bits: not a valid PNG
        _png(path, H, W, 4, 2)
        data = bytearray(open(path, 'rb').read())
    elif fault == 'no_idat':
        data = data[:33]
    if fault == 'missing':
        path = str(tmp_path / 'absent.png')
    elif fault == 'cloud':
        path = 'gs://bucket/t.png'
    else:
        with open(path, 'wb') as f:
            f.write(bytes(data))
    assert common.image_meta(path) is None
    assert 'loader.meta_headers' not in trace.counters()


def _coordinate_file(root, n=2, shape=(64, 96)):
    tdir = os.path.join(root, 'tiles')
    os.makedirs(tdir)
    lines = ['{ROOT_DIR}\t' + tdir, '{RESOLUTION}\t4']
    for k in range(n):
        fn = f'tile_{k}.png'
        _cv2_file(os.path.join(tdir, fn), shape, np.uint8, seed=k)
        x0 = k * (shape[1] - 16)
        lines.append(f'{fn}\t{x0}\t0\t{x0 + shape[1]}\t{shape[0]}')
    coord = os.path.join(root, 'coord.txt')
    with open(coord, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return coord, tdir


def test_a_loader_decodes_nothing_before_its_first_crop(tmp_path, monkeypatch):
    """Built from a coordinate file with no dtype, the loader decodes no
    tile until it crops, and serializes as the decode probe's loader did."""
    coord, _ = _coordinate_file(str(tmp_path))
    loader = dal.StaticImageLoader.from_coordinate_file(coord)
    c = trace.counters()
    assert c.get('loader.meta_headers') == 1
    assert 'loader.decodes' not in c and 'loader.meta_decodes' not in c
    got = loader.to_dict()

    with monkeypatch.context() as m:
        m.setattr(common, 'image_meta', lambda path: None)
        trace.reset_counters()
        probed = dal.StaticImageLoader.from_coordinate_file(coord)
        c = trace.counters()
    assert c.get('loader.decodes') == 1 == c.get('loader.meta_decodes')
    assert got == probed.to_dict()
    assert (got['dtype'], got['number_of_channels']) == ('uint8', 1)

    trace.reset_counters()
    a = loader.crop((10, 5, 150, 60))
    assert trace.counters().get('loader.decodes') == 2
    np.testing.assert_array_equal(a, probed.crop((10, 5, 150, 60)))


def test_a_truncated_first_tile_still_builds_a_loader(tmp_path):
    """The header of a truncated PNG still reads; the loader builds, and a
    crop of that tile raises as a crop of any unreadable tile does."""
    coord, tdir = _coordinate_file(str(tmp_path))
    first = os.path.join(tdir, 'tile_0.png')
    with open(first, 'rb') as f:
        head = f.read(200)
    with open(first, 'wb') as f:
        f.write(head)
    loader = dal.StaticImageLoader.from_coordinate_file(coord)
    with pytest.raises(RuntimeError, match='failed to read'):
        loader.crop((0, 0, 40, 40))
    # the other tile still reads
    assert loader.crop((100, 0, 150, 40)).shape == (40, 50)
