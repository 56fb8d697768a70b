"""Shared host-side utilities: the Match record, image IO, filters, bbox
algebra, Morton ordering, chunked warping, and (de)serialization helpers.

Capability parity with reference ``feabas/common.py``; device-side versions
of the filters live in ``feabas_tpu_torch.ops``.

The port's copy of ``feabas_tpu/common.py``, cut to what the port reaches.
"""

import base64
import importlib
import json
import struct
import zlib
from collections import namedtuple
from concurrent import futures

import cv2
import numpy as np
from scipy.ndimage import gaussian_filter1d

from feabas_tpu_torch import storage, trace
from feabas_tpu_torch.config import DEFAULT_AVG_DEFORM

# A batch of point correspondences between two sections/tiles.
# xy0/xy1: (N,2) float; weight: (N,) float; strain: scalar deformation proxy
# (reference: feabas/common.py:18)
Match = namedtuple('Match', ('xy0', 'xy1', 'weight', 'strain'),
                   defaults=(DEFAULT_AVG_DEFORM,))


# ------------------------------ image IO ------------------------------ #

def imread(path, **kwargs):
    flag = kwargs.get('flag', cv2.IMREAD_UNCHANGED)
    path = str(path)
    with trace.span('loader.decode'):
        if storage.is_cloud_path(path):
            with storage.File(path, 'rb') as f:
                buf = np.frombuffer(f.read(), dtype=np.uint8)
            img = cv2.imdecode(buf, flag)
        else:
            img = cv2.imread(path, flag)
    if img is not None:
        trace.count('loader.decodes')
        trace.count('loader.decoded_px', img.shape[0] * img.shape[1])
        if img.ndim == 3:
            img = img[..., ::-1]  # BGR -> RGB
    return img


_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# IHDR colour type -> the channels ``cv2.imread(..., IMREAD_UNCHANGED)``
# decodes (grey + alpha comes out BGRA), and the bit depths the format
# allows it; palette PNGs (type 3) are left out, since cv2 gives them
# three or four channels by their tRNS chunk
_PNG_CHANNELS = {0: 1, 2: 3, 4: 4, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 4: (8, 16), 6: (8, 16)}


def image_meta(path):
    """``(height, width, dtype_name, channels)`` of an image file as
    ``imread(path)`` decodes it, read from the file's header alone.

    Answers for a local PNG from its signature and IHDR chunk, and the
    chunk headers up to the first IDAT: bit depth 1-8 is ``uint8``, 16
    ``uint16``. None where the header does not settle what the decode
    gives: a palette PNG, a PNG with a tRNS chunk (cv2 then adds an alpha
    channel to RGB), any other format, a cloud path, an unreadable file,
    a bad signature or IHDR."""
    path = str(path)
    if storage.is_cloud_path(path):
        return None
    try:
        with open(path, 'rb') as f:
            head = f.read(33)
            if (len(head) < 33 or head[:8] != _PNG_SIGNATURE
                    or head[8:16] != b'\x00\x00\x00\x0dIHDR'
                    or zlib.crc32(head[12:29]) != struct.unpack('>I', head[29:])[0]):
                return None
            w, h, depth, ctype, comp, filt, interlace = struct.unpack(
                '>IIBBBBB', head[16:29])
            if (not w or not h or depth not in _PNG_DEPTHS.get(ctype, ())
                    or comp or filt or interlace > 1):
                return None
            while True:
                chunk = f.read(8)
                if len(chunk) < 8:
                    return None
                n, kind = struct.unpack('>I4s', chunk)
                if kind == b'IDAT':
                    break
                if kind == b'tRNS':
                    return None
                f.seek(n + 4, 1)   # the chunk's data and CRC
    except OSError:
        return None
    trace.count('loader.meta_headers')
    return h, w, 'uint16' if depth == 16 else 'uint8', _PNG_CHANNELS[ctype]


@trace.spanned('blender.encode')
def imwrite(path, img, **kwargs):
    path = str(path)
    if img.ndim == 3:
        img = img[..., ::-1]  # RGB -> BGR
    if storage.is_cloud_path(path):
        ext = '.' + path.rsplit('.', 1)[-1]
        ok, buf = cv2.imencode(ext, img)
        if not ok:
            raise RuntimeError(f'failed to encode image for {path}')
        with storage.File(path, 'wb') as f:
            f.write(buf.tobytes())
    else:
        d = storage.dir_name(path)
        if d:
            storage.makedirs(d)
        if not cv2.imwrite(path, img):
            raise RuntimeError(f'failed to write image {path}')
    trace.count('blender.encodes')


def imwrite_many(items):
    """Write each ``(path, img)`` of items as ``imwrite(path, img)`` would,
    side by side where the process has the cores for it.

    The width is the loaders' decode width (``dal._decode_width``): as many
    files as there are, up to the cores; one in a process that
    multiprocessing started, and then this is ``imwrite`` in a loop.
    Wider, the calling thread writes the first file itself while the
    others go to the decode pool (``cv2.imwrite`` releases the GIL), at
    most width - 1 of them in flight there. Every write goes through the
    module's ``imwrite``, so a wrapper put on it wraps each. The first
    exception reaches the caller once every write in flight has ended;
    no file after it is started."""
    from feabas_tpu_torch import dal
    items = list(items)
    width = dal._decode_width(len(items))
    if width < 2:
        for path, img in items:
            imwrite(path, img)
        return
    trace.count('render.encode_batches')
    pool = dal.decode_pool()
    rest = iter(items[1:])
    inflight = set()

    def submit():
        item = next(rest, None)
        if item is not None:
            inflight.add(pool.submit(imwrite, *item))
    with trace.span('render.encode_batch'):
        try:
            for _ in range(width - 1):
                submit()
            imwrite(*items[0])
            trace.count('render.batched_encodes')
            while inflight:
                done, _ = futures.wait(inflight,
                                       return_when=futures.FIRST_COMPLETED)
                for f in done:
                    inflight.discard(f)
                    f.result()
                    trace.count('render.batched_encodes')
                    submit()
        finally:
            for f in inflight:
                f.cancel()
            futures.wait(inflight)


# ------------------------------ masks & filters ------------------------------ #

def cross2d(v0, v1):
    return v0[..., 0] * v1[..., 1] - v0[..., 1] * v1[..., 0]


def masked_dog_filter(img, sigma, mask=None, signed=True):
    """Difference-of-Gaussian band-pass with mask-bleed suppression.

    Energy that Gaussian blur leaks across the mask boundary is estimated by
    filtering the mask complement and subtracted from the response magnitude
    (reference behavior: feabas/common.py:353-378). img: (...,H,W).
    """
    if not np.issubdtype(img.dtype, np.floating):
        img = img.astype(np.float32)
    s0 = s1 = float(sigma)
    f0 = gaussian_filter1d(gaussian_filter1d(img, s0, axis=-1, mode='nearest'),
                           s0, axis=-2, mode='nearest')
    f1 = gaussian_filter1d(gaussian_filter1d(f0, s1, axis=-1, mode='nearest'),
                           s1, axis=-2, mode='nearest')
    imgf = f0 - f1
    if (mask is not None) and (not np.all(mask)):
        mask_img = np.ptp(img) * (mask == 0).astype(np.float32)
        sc = (s0 ** 2 + s1 ** 2) ** 0.5
        maskf = gaussian_filter1d(gaussian_filter1d(mask_img, sc, axis=-1, mode='nearest'),
                                  sc, axis=-2, mode='nearest') * (sc ** 2) / (s0 ** 2)
        mag = np.clip(np.abs(imgf) - maskf, 0, None)
        imgf = mag * np.sign(imgf)
    if not signed:
        imgf = np.abs(imgf)
    return imgf


# ------------------------------ bbox algebra ------------------------------ #
# bboxes are (xmin, ymin, xmax, ymax)

def intersect_bbox(bbox0, bbox1):
    xmin = max(bbox0[0], bbox1[0])
    ymin = max(bbox0[1], bbox1[1])
    xmax = min(bbox0[2], bbox1[2])
    ymax = min(bbox0[3], bbox1[3])
    return (xmin, ymin, xmax, ymax), (xmin < xmax) and (ymin < ymax)


def bbox_centers(bboxes):
    bboxes = np.asarray(bboxes).reshape(-1, 4)
    return (bboxes[:, :2] + bboxes[:, 2:]) / 2


def bbox_enlarge(bbox, margin):
    m = np.asarray(margin)
    if m.size == 1:
        m = np.repeat(m, 2)
    b = np.asarray(bbox, dtype=np.float64).copy()
    b[:2] -= m
    b[2:] += m
    return b


def divide_bbox(bbox, block_size=None, min_num_blocks=1, round_output=True,
                shrink_factor=1.0):
    """Split a bbox into a grid of roughly-equal blocks; returns
    (xmins, ymins, xmaxs, ymaxs) flat arrays (reference: common.py:380)."""
    xmin, ymin, xmax, ymax = bbox
    ht, wd = ymax - ymin, xmax - xmin
    if block_size is None:
        block_size = max(ht, wd)
    if not hasattr(block_size, '__len__'):
        block_size = (block_size, block_size)
    if not hasattr(min_num_blocks, '__len__'):
        min_num_blocks = (min_num_blocks, min_num_blocks)
    Nx = int(max(np.ceil(wd / block_size[1]), min_num_blocks[1]))
    Ny = int(max(np.ceil(ht / block_size[0]), min_num_blocks[0]))
    dx = int(np.ceil(wd / Nx))
    dy = int(np.ceil(ht / Ny))
    xt = np.linspace(xmin, xmax - dx, num=Nx, endpoint=True)
    yt = np.linspace(ymin, ymax - dy, num=Ny, endpoint=True)
    if shrink_factor != 1:
        dxn, dyn = dx * shrink_factor, dy * shrink_factor
        xt = xt + (dx - dxn) / 2
        yt = yt + (dy - dyn) / 2
        dx, dy = int(np.ceil(dxn)), int(np.ceil(dyn))
    if round_output:
        xt = np.round(xt).astype(np.int64)
        yt = np.round(yt).astype(np.int64)
    xx, yy = np.meshgrid(xt, yt)
    return xx.ravel(), yy.ravel(), xx.ravel() + dx, yy.ravel() + dy


# ------------------------------ orderings ------------------------------ #

def z_order(indices, base=2):
    """Morton (Z-curve) argsort of integer grid coordinates (N, ndim) —
    cache-friendly task ordering (reference: common.py:196)."""
    indices = np.asarray(indices, dtype=np.int64).reshape(indices.shape[0], -1)
    indices = indices - indices.min(axis=0)
    nbits = max(int(np.max(indices)).bit_length(), 1)
    key = np.zeros(indices.shape[0], dtype=np.uint64)
    for bit in range(nbits):
        for d in range(indices.shape[1]):
            key |= (((indices[:, d].astype(np.uint64) >> np.uint64(bit)) & np.uint64(1))
                    << np.uint64(bit * indices.shape[1] + d))
    return np.argsort(key, kind='stable')


# ------------------------------ warping ------------------------------ #

def remap(img, map_x, map_y, interpolation=cv2.INTER_LINEAR,
          borderMode=cv2.BORDER_CONSTANT, borderValue=0):
    """cv2.remap that sidesteps the SHRT_MAX size limit by chunking
    (reference: common.py:218)."""
    map_x = np.ascontiguousarray(map_x, dtype=np.float32)
    map_y = np.ascontiguousarray(map_y, dtype=np.float32)
    shp = map_x.shape
    LIM = 32000
    if max(shp) < LIM and max(img.shape[:2]) < LIM:
        return cv2.remap(img, map_x, map_y, interpolation=interpolation,
                         borderMode=borderMode, borderValue=borderValue)
    flat_x, flat_y = map_x.reshape(1, -1), map_y.reshape(1, -1)
    out = np.empty(flat_x.shape[1:2] + img.shape[2:], dtype=img.dtype)
    step = LIM * LIM // 2
    for i in range(0, flat_x.shape[1], step):
        sl = slice(i, min(i + step, flat_x.shape[1]))
        out[sl] = cv2.remap(img, flat_x[:, sl], flat_y[:, sl],
                            interpolation=interpolation, borderMode=borderMode,
                            borderValue=borderValue).reshape((-1,) + img.shape[2:])
    return out.reshape(shp + img.shape[2:])


_INTERP_NAMES = {
    'NEAREST': cv2.INTER_NEAREST, 'LINEAR': cv2.INTER_LINEAR,
    'CUBIC': cv2.INTER_CUBIC, 'LANCZOS': cv2.INTER_LANCZOS4,
    'AREA': cv2.INTER_AREA,
}


def interp_from_name(name, default=cv2.INTER_LINEAR):
    """Map config strings (LANCZOS | CUBIC | LINEAR | NEAREST) to cv2
    interpolation flags (reference config surface:
    default_alignment_configs.yaml remap_interp)."""
    if name is None:
        return default
    if isinstance(name, int):
        return name
    return _INTERP_NAMES.get(str(name).upper(), default)


def render_by_subregions(map_x, map_y, mask, img_loader, fileid=None, **kwargs):
    """Chunked inverse warp against an image loader so huge sources never
    fully load (reference behavior: common.py:256). The coordinate maps are
    split into blocks; each block crops only its source bbox then samples.
    """
    rintp = kwargs.pop('interpolation', cv2.INTER_LINEAR)
    fillval = kwargs.pop('fillval', getattr(img_loader, 'default_fillval', 0))
    dtype_out = kwargs.pop('dtype_out', getattr(img_loader, 'dtype', np.uint8))
    block_size = kwargs.pop('block_size', 4096)
    if kwargs.pop('device_remap', False):
        raise NotImplementedError(
            'device_remap=True: feabas_tpu.ops.warp.remap_device is not '
            'ported')
    kwargs.pop('return_empty', None)  # we manage emptiness per block
    if map_x.size == 0:
        return None
    out_shape = map_x.shape
    num_channel = getattr(img_loader, 'number_of_channels', None)
    if num_channel and num_channel > 1:
        imgt = np.full(out_shape + (num_channel,), fillval, dtype=dtype_out)
    else:
        num_channel = None
        imgt = np.full(out_shape, fillval, dtype=dtype_out)
    x0s, y0s, x1s, y1s = divide_bbox((0, 0, out_shape[1], out_shape[0]),
                                     block_size=block_size)
    for bx0, by0, bx1, by1 in zip(x0s, y0s, x1s, y1s):
        mx = map_x[by0:by1, bx0:bx1]
        my = map_y[by0:by1, bx0:bx1]
        mk = mask[by0:by1, bx0:bx1] if mask is not None else np.isfinite(mx)
        mk = mk & np.isfinite(mx) & np.isfinite(my)
        if not np.any(mk):
            continue
        xmin = int(np.floor(mx[mk].min())) - 2
        xmax = int(np.ceil(mx[mk].max())) + 2
        ymin = int(np.floor(my[mk].min())) - 2
        ymax = int(np.ceil(my[mk].max())) + 2
        if fileid is not None:
            src = img_loader.crop((xmin, ymin, xmax, ymax), fileid, return_empty=True, **kwargs)
        else:
            src = img_loader.crop((xmin, ymin, xmax, ymax), return_empty=True, **kwargs)
        if src is None:
            continue
        mxs = np.where(mk, mx, xmin).astype(np.float32) - xmin
        mys = np.where(mk, my, ymin).astype(np.float32) - ymin
        blk = remap(src, mxs, mys, interpolation=rintp,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=fillval)
        tgt = imgt[by0:by1, bx0:bx1]
        if num_channel:
            tgt[mk] = blk[mk]
        else:
            tgt[mk] = blk[mk]
        imgt[by0:by1, bx0:bx1] = tgt
    return imgt


# ------------------------------ coordinate files ------------------------------ #

def parse_coordinate_files(filename, **kwargs):
    """Parse a stitch coordinate TSV (reference format, common.py:719).

    Rows: ``image_path  x_min  y_min  [x_max  y_max]``; headers
    ``{ROOT_DIR}``, ``{TILE_SIZE}``, ``{RESOLUTION}``.
    Returns (imgpaths, bboxes, root_dir, resolution).
    """
    root_dir = kwargs.get('root_dir', None)
    tile_size = kwargs.get('tile_size', None)
    delimiter = kwargs.get('delimiter', '\t')
    resolution = kwargs.get('resolution', None)
    tile_folder = None
    tile_pattern = '_tr{ROW_IND}-tc{COL_IND}.png'
    one_based = True
    with storage.File(filename, 'r') as f:
        lines = [ln for ln in (s.strip('\n') for s in f.readlines()) if ln.strip()]
    if not lines:
        raise RuntimeError(f'empty coordinate file: {filename}')
    start = 0
    for line in lines:
        t = line.strip().split(delimiter)
        if '{ROOT_DIR}' in line:
            start += 1
            if len(t) >= 2:
                root_dir = t[1]
        elif '{TILE_SIZE}' in line:
            start += 1
            if len(t) == 2:
                tile_size = (int(t[1]), int(t[1]))
            elif len(t) > 2:
                tile_size = (int(t[1]), int(t[2]))
        elif '{RESOLUTION}' in line:
            start += 1
            if len(t) >= 2:
                resolution = float(t[1])
        elif '{TILE_FOLDER}' in line:
            # bare-folder ingestion: no coordinate rows — tile positions
            # are parsed from the FILENAMES (reference
            # MosaicLoader.from_filepath: dal.py:868-1006)
            start += 1
            if len(t) >= 2:
                tile_folder = t[1]
        elif '{PATTERN}' in line:
            start += 1
            if len(t) >= 2:
                tile_pattern = t[1]
        elif '{ONE_BASED}' in line:
            start += 1
            if len(t) >= 2:
                one_based = t[1].strip().lower() in ('1', 'true', 'yes')
        else:
            break
    if tile_folder is not None:
        import os
        from feabas_tpu_torch.dal import parse_pattern_filename
        pat = os.path.splitext(tile_pattern)[0]
        pat = pat.replace('{', '({').replace('}', r'}\d+)')
        paths = sorted(
            p for p in storage.list_folder_content(
                storage.join_paths(tile_folder, '*'))
            if p.rsplit('.', 1)[-1].lower() in
            ('png', 'jpg', 'jpeg', 'tif', 'tiff', 'bmp'))
        if not paths:
            raise RuntimeError(f'no image found in {tile_folder}')
        img = imread(paths[0], flag=cv2.IMREAD_GRAYSCALE)
        if tile_size is None:
            # no {TILE_SIZE} step given: tiles assumed to abut exactly
            tile_size = img.shape[:2]
        shift = np.asarray([-tile_size[-1], -tile_size[0]] * 2, np.float64) \
            if one_based else 0.0
        imgpaths, bboxes = [], []
        for p in paths:
            bbox = np.asarray(parse_pattern_filename(
                storage.base_name(p), pat, tile_size), np.float64) + shift
            # tile_size is the POSITION STEP (smaller than the image when
            # tiles overlap); the bbox extent is the actual image size
            bbox[2] = bbox[0] + img.shape[1]
            bbox[3] = bbox[1] + img.shape[0]
            imgpaths.append(storage.base_name(p))
            bboxes.append(tuple(bbox))
        return imgpaths, bboxes, tile_folder, resolution
    imgpaths, bboxes = [], []
    for line in lines[start:]:
        t = line.strip().split(delimiter)
        if len(t) < 3:
            raise RuntimeError(f'corrupted coordinate file: {filename}')
        mpath, x_min, y_min = t[0], float(t[1]), float(t[2])
        if len(t) >= 5 and tile_size is None:
            x_max, y_max = float(t[3]), float(t[4])
        else:
            if tile_size is None:
                p = storage.join_paths(root_dir, mpath) if root_dir else mpath
                img = imread(p, flag=cv2.IMREAD_GRAYSCALE)
                tile_size = img.shape
            x_max = x_min + tile_size[-1]
            y_max = y_min + tile_size[0]
        imgpaths.append(mpath)
        bboxes.append((x_min, y_min, x_max, y_max))
    return imgpaths, bboxes, root_dir, resolution


def get_canvas_bbox(canvas_file, target_mip=0):
    """Canvas bbox from a ``{'mipN': [x0, y0, x1, y1]}`` JSON, rescaled
    from the nearest stored mip to ``target_mip`` (reference:
    common.py:799)."""
    import json
    if isinstance(canvas_file, dict):
        data = canvas_file
    else:
        with storage.File(canvas_file, 'r') as f:
            data = json.load(f)
    mips = {float(k.replace('mip', '')): v for k, v in data.items()
            if k.startswith('mip')}
    if not mips:
        return None
    src = min(mips, key=lambda m: abs(m - target_mip))
    bbox = np.asarray(mips[src], np.float64).ravel() * 2.0 ** (src - target_mip)
    return [int(np.floor(bbox[0])), int(np.floor(bbox[1])),
            int(np.ceil(bbox[2])), int(np.ceil(bbox[3]))]


def unique_prefix_arg(choices):
    """argparse ``type`` that expands a unique prefix of ``choices``
    (reference drivers accept e.g. ``--mode opt``); ambiguous or unknown
    prefixes raise with the choice list."""
    import argparse

    def parse(v):
        lv = str(v).lower()
        hits = [c for c in choices if c.startswith(lv)]
        if len(hits) != 1:
            raise argparse.ArgumentTypeError(
                f'mode {v!r} does not uniquely match one of {choices}')
        return hits[0]
    return parse


def rearrange_section_order(section_list, section_order_file):
    """Reorder/filter sections by a `section_order.txt`: one name per line,
    or an explicit ``z<TAB>name`` per line (reference: common.py:814-828).
    Returns (ordered_list, z_indices)."""
    if (section_order_file is None) or (not storage.file_exists(section_order_file)):
        return section_list, np.arange(len(section_list))
    with storage.File(section_order_file, 'r') as f:
        lines = [ln.strip() for ln in f.readlines() if ln.strip()]
    lut = {}
    for k, ln in enumerate(lines):
        if '\t' in ln:
            z, name = ln.split('\t')[:2]
            lut[name] = int(z)
        else:
            lut[ln] = k
    pairs = [(lut[s], s) for s in section_list if s in lut]
    pairs.sort()
    if not pairs:
        return [], np.array([], dtype=int)
    zs, names = zip(*pairs)
    return list(names), np.asarray(zs)


# ------------------------------ (de)serialization ------------------------------ #

def str_to_numpy_ascii(s):
    return np.frombuffer(s.encode('ascii', errors='replace'), dtype=np.uint8).copy()


def numpy_to_str_ascii(arr):
    if isinstance(arr, bytes):
        return arr.decode()
    if isinstance(arr, str):
        return arr
    return bytes(np.asarray(arr, dtype=np.uint8)).decode('ascii', errors='replace')


# Work-dir files (material tables, mesh H5s) name functions under the JAX
# package's module path, ``feabas_tpu.<module>::<name>``; the port writes
# the same strings and reads them as its own modules of the same name, so
# the files stay interchangeable between the two packages.
_FILE_PKG, _PKG = 'feabas_tpu', 'feabas_tpu_torch'


def _swap_package(modname, old, new):
    if modname == old or modname.startswith(old + '.'):
        return new + modname[len(old):]
    return modname


def func_to_str(func, **params):
    """Serialize a callable factory reference to a string.  Named module
    functions serialize as 'module.submodule::qualname' (the port's modules
    under the JAX package's name); arbitrary callables fall back to
    dill+base64 (reference: common.py:450)."""
    if func is None:
        return None
    if isinstance(func, str):
        return func
    mod = getattr(func, '__module__', None)
    name = getattr(func, '__qualname__', getattr(func, '__name__', None))
    if mod and name and '<' not in name:
        return f'{_swap_package(mod, _PKG, _FILE_PKG)}::{name}'
    import dill
    return 'dill::' + base64.b64encode(dill.dumps(func)).decode('ascii')


def str_to_func(s, **params):
    """Inverse of :func:`func_to_str` (a ``feabas_tpu.`` module path
    resolves to the port's module); if params given, calls the factory
    with them and returns the result."""
    if s is None:
        return None
    if callable(s):
        func = s
    elif s.startswith('dill::'):
        import dill
        func = dill.loads(base64.b64decode(s[len('dill::'):]))
    else:
        modname, _, qualname = s.partition('::')
        if not qualname:  # legacy 'module.attr' form
            modname, _, qualname = s.rpartition('.')
        obj = importlib.import_module(_swap_package(modname, _FILE_PKG, _PKG))
        for attr in qualname.split('.'):
            obj = getattr(obj, attr)
        func = obj
    if params:
        return func(**params)
    return func


# ------------------------------ misc ------------------------------ #

