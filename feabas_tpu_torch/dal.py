"""Data access layer: image loaders with caching and preprocessing.

Loaders serve ``crop(bbox)`` requests composed from tiles on disk, cloud
buckets, in-memory arrays, or tensorstore volumes (capability parity with
reference ``feabas/dal.py``). All loaders JSON-round-trip so worker
processes rebuild them from specs. Volumes open through ``ts``:
tensorstore where it is installed, else the port's ``_tslite``.

The port's copy of ``feabas_tpu/dal.py``, cut to what the port reaches.
"""

import json
import multiprocessing
import os
import threading
from collections import deque
from concurrent import futures

import cv2
import numpy as np

from feabas_tpu_torch import common, storage, trace
from feabas_tpu_torch.caching import generate_cache
from feabas_tpu_torch.utils.spatial_index import GridIndex

try:
    import tensorstore as ts
except ImportError:     # the port's precomputed subset stands in for it
    from feabas_tpu_torch import _tslite as ts


def _count_lookup(hit):
    trace.count('loader.cache_lookups')
    if hit:
        trace.count('loader.cache_hits')


_POOL = None
_POOL_LOCK = threading.Lock()


def _cores():
    return len(os.sched_getaffinity(0))


def decode_pool():
    """The process's one thread pool of tile decodes and encodes, made at
    first use, one thread a core the process may run on. ``cv2.imread``
    and ``cv2.imwrite`` release the GIL, so the threads decode (and
    ``common.imwrite_many``'s files encode) side by side; every loader and
    every thread of a threaded fan-out shares the pool, so the process
    never runs its codecs on more threads than it has cores. A task on
    the pool never submits to it."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = futures.ThreadPoolExecutor(
                max_workers=_cores(), thread_name_prefix='feabas-decode')
        return _POOL


def _decode_width(reads):
    """Tiles a crop decodes at once: as many as it has to read, up to the
    cores; one in a process that multiprocessing started, whose siblings
    already hold the cores."""
    if reads < 2 or multiprocessing.parent_process() is not None:
        return 1
    return min(reads, _cores())


def _paste_block(out, blk, at):
    """Paste a tile's block at (row, col) ``at`` of out; False where the
    block is empty. The image on disk may be smaller than its recorded
    tile bbox (ragged edge tiles): only what was read is pasted, the rest
    keeps the fill value."""
    if blk.size == 0:
        return False
    bh, bw = blk.shape[:2]
    out[at[0]:at[0] + bh, at[1]:at[1] + bw] = blk
    return True


def _file_meta(path):
    """``(height, width, dtype_name, channels)`` of an image file: from its
    header where ``common.image_meta`` reads one, else from a whole decode
    (counted as ``loader.meta_decodes``); None where neither reads it."""
    meta = common.image_meta(path)
    if meta is not None:
        return meta
    img = common.imread(path, flag=cv2.IMREAD_UNCHANGED)
    if img is None:
        return None
    trace.count('loader.meta_decodes')
    return (img.shape[0], img.shape[1], img.dtype.name,
            1 if img.ndim == 2 else img.shape[-1])


def _apply_clahe(img, cliplimit=2.0):
    clahe = cv2.createCLAHE(clipLimit=cliplimit, tileGridSize=(8, 8))
    if img.ndim == 2:
        return clahe.apply(img)
    return np.stack([clahe.apply(img[..., c]) for c in range(img.shape[-1])], -1)


class AbstractImageLoader:
    """Common crop/preprocess/caching machinery (reference: dal.py:121)."""

    def __init__(self, **kwargs):
        self._dtype = kwargs.get('dtype', None)
        self._default_fillval = kwargs.get('fillval', 0)
        self._apply_CLAHE = kwargs.get('apply_CLAHE', False)
        self._CLAHE_cliplimit = kwargs.get('CLAHE_cliplimit', 2.0)
        self._inverse = kwargs.get('inverse', False)
        self._number_of_channels = kwargs.get('number_of_channels', None)
        self.resolution = kwargs.get('resolution', None)
        cache_size = kwargs.get('cache_size', 0)
        cache_type = kwargs.get('cache_type', 'lru')
        # cache_capacity: byte cap in MiB (reference: dal.py:132,152)
        cache_capacity = kwargs.get('cache_capacity', None)
        self._cache = generate_cache(
            cache_type if (cache_size or cache_capacity) else 'none',
            maxlen=cache_size or None,
            maxbytes=None if cache_capacity is None
            else int(cache_capacity * 2 ** 20))
        self._preprocess = kwargs.get('preprocess', None)
        # per-image intensity transfer LUTs (reference tf_lut: dal.py:492):
        # a JSON path or dict {'__TYPE__': 'INTERP1D' |
        # 'BRIGHTNESS_CONTRAST_ADJUST', <image name>: vals}; INTERP1D vals
        # are (src_grays, tgt_grays) control points, the other is
        # (brightness_offset, contrast_gain)
        self._tf_lut = kwargs.get('tf_lut', None)
        self._tf_lut_cache = None

    def _tf_for(self, name):
        """Intensity transfer callable for an image name, or None."""
        if self._tf_lut is None:
            return None
        if self._tf_lut_cache is None:
            lut = self._tf_lut
            if isinstance(lut, str):
                with storage.File(lut, 'r') as f:
                    lut = json.load(f)
            tf_type = lut.get('__TYPE__', 'INTERP1D')
            cache = {}
            for nm, vals in lut.items():
                if nm == '__TYPE__':
                    continue
                if tf_type == 'INTERP1D':
                    xp = np.asarray(vals[0], np.float64).ravel()
                    fp = np.asarray(vals[1], np.float64).ravel()
                    cache[nm] = (lambda img, xp=xp, fp=fp:
                                 np.interp(img.astype(np.float64), xp, fp))
                else:  # BRIGHTNESS_CONTRAST_ADJUST
                    b, c = float(vals[0]), float(vals[1])
                    cache[nm] = (lambda img, b=b, c=c:
                                 img.astype(np.float64) * c + b)
            self._tf_lut_cache = cache
        key = storage.base_name(str(name))
        cache = self._tf_lut_cache
        return cache.get(key, cache.get(str(name)))

    def _apply_tf(self, img, name):
        tf = self._tf_for(name)
        if tf is None or img is None:
            return img
        out = tf(img)
        if np.issubdtype(img.dtype, np.integer):
            info = np.iinfo(img.dtype)
            out = np.clip(np.round(out), info.min, info.max)
        return out.astype(img.dtype, copy=False)

    # -- to be provided by subclasses --
    def crop(self, bbox, **kwargs):
        raise NotImplementedError

    @property
    def dtype(self):
        return self._dtype if self._dtype is not None else np.uint8

    @property
    def default_fillval(self):
        return self._default_fillval

    @property
    def number_of_channels(self):
        return self._number_of_channels

    def preprocess(self, img):
        if img is None:
            return None
        if self._apply_CLAHE and np.issubdtype(img.dtype, np.integer):
            img = _apply_clahe(img, self._CLAHE_cliplimit)
        if self._inverse:
            if np.issubdtype(img.dtype, np.integer):
                img = np.iinfo(img.dtype).max - img
            else:
                img = img.max() - img
        if self._preprocess is not None:
            img = self._preprocess(img)
        if self._dtype is not None:
            img = img.astype(np.dtype(self._dtype), copy=False)
        return img

    def _settings_dict(self):
        return {
            'dtype': None if self._dtype is None else np.dtype(self._dtype).name,
            'fillval': self._default_fillval,
            'apply_CLAHE': self._apply_CLAHE,
            'CLAHE_cliplimit': self._CLAHE_cliplimit,
            'inverse': self._inverse,
            'number_of_channels': self._number_of_channels,
            'resolution': self.resolution,
            'cache_size': getattr(self._cache, '_maxlen', None) or 0,
            'tf_lut': self._tf_lut,
        }

    def to_dict(self):
        d = self._settings_dict()
        d['loader_type'] = type(self).__name__
        return d

    def to_json(self, path=None):
        s = json.dumps(self.to_dict())
        if path is not None:
            with storage.File(path, 'w') as f:
                f.write(s)
        return s

    def _cached(self, key):
        # atomic get: a concurrent insert+trim may evict between a
        # membership check and the indexing (threaded mip fan-out)
        val = self._cache.get(key)
        _count_lookup(val is not None)
        return val

    def _decode(self, path):
        """Decode an image file with the transfer function and the
        preprocessing applied."""
        img = common.imread(path, flag=cv2.IMREAD_UNCHANGED)
        if img is None:
            raise RuntimeError(f'failed to read {path}')
        return self.preprocess(self._apply_tf(img, path))

    def _read_image(self, path):
        img = self._cached(path)
        if img is None:
            img = self._decode(path)
            self._cache[path] = img
        return img

    def _blank(self, bbox, fillval=None):
        w = int(round(bbox[2] - bbox[0]))
        h = int(round(bbox[3] - bbox[1]))
        fv = self._default_fillval if fillval is None else fillval
        shape = (h, w) if not self._number_of_channels or self._number_of_channels == 1 \
            else (h, w, self._number_of_channels)
        return np.full(shape, fv, dtype=self.dtype)


class DynamicImageLoader(AbstractImageLoader):
    """Path provided at crop time (reference: dal.py:516)."""

    def crop(self, bbox, imgpath, img_bbox=None, return_empty=False, **kwargs):
        img = self._read_image(imgpath)
        if img_bbox is None:
            img_bbox = (0, 0, img.shape[1], img.shape[0])
        return _paste_crop(self._blank(bbox, kwargs.get('fillval')), bbox,
                           img, img_bbox, return_empty=return_empty)


class StaticImageLoader(AbstractImageLoader):
    """Indexed tile list with bboxes in a shared world frame
    (reference: dal.py:604)."""

    def __init__(self, imgpaths, bboxes, root_dir=None, **kwargs):
        super().__init__(**kwargs)
        self.imgpaths = list(imgpaths)
        self.bboxes = np.asarray(bboxes, dtype=np.float64).reshape(-1, 4)
        self.root_dir = root_dir
        self._index = None
        # border-block caching (reference tile dividers: dal.py:33-62):
        # stitch matching only reads tile borders (the overlaps), so with
        # cache_border_margin set, only four border bands per tile are
        # cached — an interior-touching crop re-reads the file but leaves
        # the cache footprint tiny
        self._cache_border_margin = int(kwargs.get('cache_border_margin', 0) or 0)
        if self._dtype is None or self._number_of_channels is None:
            self._probe_meta(kwargs)

    def _border_blocks(self, h, w):
        """Local-frame bboxes of the four cached border bands (reference
        _tile_divider_border: dal.py:40)."""
        m = self._cache_border_margin
        bh = min(m, h // 2)
        bw = min(m, w // 2)
        return [(0, 0, w - bw, bh),          # top (minus right corner)
                (0, bh, bw, h),              # left
                (bw, h - bh, w, h),          # bottom
                (w - bw, 0, w, h - bh)]      # right

    def _tile_bands(self, fileid):
        tw = int(round(self.bboxes[fileid, 2] - self.bboxes[fileid, 0]))
        th = int(round(self.bboxes[fileid, 3] - self.bboxes[fileid, 1]))
        return self._border_blocks(th, tw)

    def _cached_tile_local(self, fileid, lb):
        """Tile fileid's integer local bbox lb (x0, y0, x1, y1), already
        clipped, as the cache holds it: from the whole image, or with
        border-band caching assembled from the bands when they cover lb;
        else None."""
        path = self.abs_path(fileid)
        if self._cache_border_margin <= 0:
            img = self._cached(path)
            return None if img is None else img[lb[1]:lb[3], lb[0]:lb[2]]
        covering = []
        for bi, bb in enumerate(self._tile_bands(fileid)):
            blk = self._cached((path, bi))
            if blk is not None:
                covering.append((bb, blk))
        out = np.empty((lb[3] - lb[1], lb[2] - lb[0]), self.dtype) \
            if not self._number_of_channels or self._number_of_channels == 1 \
            else np.empty((lb[3] - lb[1], lb[2] - lb[0],
                           self._number_of_channels), self.dtype)
        filled = np.zeros(out.shape[:2], bool)
        for bb, blk in covering:
            cx0, cx1 = max(lb[0], bb[0]), min(lb[2], bb[2])
            cy0, cy1 = max(lb[1], bb[1]), min(lb[3], bb[3])
            if cx0 >= cx1 or cy0 >= cy1:
                continue
            sblk = blk[cy0 - bb[1]:cy1 - bb[1], cx0 - bb[0]:cx1 - bb[0]]
            # cached bands cut from a short (ragged-edge) image can be
            # smaller than their nominal bbox: copy what exists
            sh, sw = sblk.shape[:2]
            out[cy0 - lb[1]:cy0 - lb[1] + sh,
                cx0 - lb[0]:cx0 - lb[0] + sw] = sblk
            filled[cy0 - lb[1]:cy0 - lb[1] + sh,
                   cx0 - lb[0]:cx0 - lb[0] + sw] = True
        return out if filled.all() else None

    def _decode_tile_local(self, fileid, lb):
        """Decode tile fileid, cache it (whole, or with border-band caching
        its four bands alone) and crop lb from it."""
        path = self.abs_path(fileid)
        img = self._decode(path)
        if self._cache_border_margin <= 0:
            self._cache[path] = img
        else:
            for bi, bb in enumerate(self._tile_bands(fileid)):
                key = (path, bi)
                if key not in self._cache:
                    self._cache[key] = np.ascontiguousarray(
                        img[bb[1]:bb[3], bb[0]:bb[2]])
        return img[lb[1]:lb[3], lb[0]:lb[2]]

    def _probe_meta(self, kwargs):
        if not self.imgpaths:
            return
        try:
            meta = _file_meta(self.abs_path(0))
            if meta is not None:
                if self._dtype is None:
                    self._dtype = meta[2]
                if self._number_of_channels is None:
                    self._number_of_channels = meta[3]
        except Exception:
            pass

    @classmethod
    def from_coordinate_file(cls, filename, **kwargs):
        imgpaths, bboxes, root_dir, resolution = common.parse_coordinate_files(
            filename, **{k: kwargs.pop(k) for k in ('root_dir', 'tile_size', 'delimiter')
                         if k in kwargs})
        if resolution is not None:
            kwargs.setdefault('resolution', resolution)
        return cls(imgpaths, bboxes, root_dir=root_dir, **kwargs)

    @classmethod
    def from_filepath(cls, imgpaths,
                      pattern=r'_tr({ROW_IND}\d+)-tc({COL_IND}\d+)',
                      **kwargs):
        """Build a loader from a bare tile folder — mosaic positions are
        parsed from the FILENAMES, no coordinate file needed (reference
        MosaicLoader.from_filepath: dal.py:868-1006).

        Args:
            imgpaths: list of paths, a glob, or a directory.
            pattern: regex with ``{ROW_IND}/{COL_IND}/{X_MIN}/{Y_MIN}/
                {X_MAX}/{Y_MAX}`` keyword markers inside capture groups.
            tile_size: (h, w); read from the first image when omitted.
            tile_offset: (col, row) shift in tile units (e.g. (-1, -1)
                for one-based row/col indices).
            pixel_offset: (x, y) shift in pixels.
        """
        tile_size = kwargs.pop('tile_size', None)
        tile_offset = kwargs.pop('tile_offset', None)
        pixel_offset = kwargs.pop('pixel_offset', None)
        if isinstance(imgpaths, str):
            import os
            pat = imgpaths
            if '*' not in pat and (os.path.isdir(pat)
                                   or not storage.file_exists(pat)):
                pat = storage.join_paths(pat, '*')
            if '*' in pat:
                imgpaths = sorted(
                    p for p in storage.list_folder_content(pat)
                    if p.rsplit('.', 1)[-1].lower() in
                    ('png', 'jpg', 'jpeg', 'tif', 'tiff', 'bmp'))
                if not imgpaths:
                    raise RuntimeError(f'no image found: {pat}')
            else:
                imgpaths = [pat]
        if tile_size is None:
            meta = _file_meta(imgpaths[0])
            if meta is None:
                raise RuntimeError(f'failed to read {imgpaths[0]}')
            tile_size = meta[:2]
        bboxes = []
        for fname in imgpaths:
            bbox = np.asarray(
                parse_pattern_filename(storage.base_name(fname), pattern,
                                       tile_size), np.float64)
            if tile_offset is not None:
                bbox += np.asarray([tile_offset[0] * tile_size[-1],
                                    tile_offset[-1] * tile_size[0]] * 2)
            if pixel_offset is not None:
                bbox += np.asarray([pixel_offset[0], pixel_offset[1]] * 2)
            bboxes.append(bbox)
        return cls(imgpaths, bboxes, **kwargs)

    def abs_path(self, fileid):
        p = self.imgpaths[fileid]
        if self.root_dir:
            return storage.join_paths(self.root_dir, p)
        return p

    @property
    def file_index(self):
        if self._index is None:
            self._index = GridIndex(self.bboxes)
        return self._index

    def _tile_window(self, bbox, fileid):
        """(local bbox, (row, col) in the crop) of tile fileid's overlap
        with world bbox, or None where they do not overlap."""
        tb = self.bboxes[fileid]
        x0, y0 = int(round(bbox[0])), int(round(bbox[1]))
        # derive the far corner from the SAME integerization ``_blank``
        # uses for the canvas shape: rounding both edges independently
        # disagrees with round(width) by 1 px for float bboxes like
        # (10.5, 139.0) and overruns the canvas (found by the 10k-tile
        # MultiSEM rehearsal)
        x1 = x0 + int(round(bbox[2] - bbox[0]))
        y1 = y0 + int(round(bbox[3] - bbox[1]))
        ix0, iy0 = int(round(tb[0])), int(round(tb[1]))
        ix1, iy1 = int(round(tb[2])), int(round(tb[3]))
        cx0, cx1 = max(x0, ix0), min(x1, ix1)
        cy0, cy1 = max(y0, iy0), min(y1, iy1)
        if cx0 >= cx1 or cy0 >= cy1:
            return None
        return ((cx0 - ix0, cy0 - iy0, cx1 - ix0, cy1 - iy0),
                (cy0 - y0, cx0 - x0))

    def crop(self, bbox, fileid=None, return_empty=False, **kwargs):
        """Crop the mosaic (or one indexed tile when fileid given).

        The tiles are pasted in the file index's order (a later tile wins
        where tiles overlap). Where two or more of them are not in the
        cache, they decode on the process's decode pool while the calling
        thread pastes, no more of them in flight than the crop's decode
        width."""
        out = self._blank(bbox, kwargs.get('fillval'))
        fids = [fileid] if fileid is not None else self.file_index.query(bbox)
        parts = []
        for fid in map(int, fids):
            win = self._tile_window(bbox, fid)
            if win is not None:
                parts.append((fid, *win, self._cached_tile_local(fid, win[0])))
        reads = [(fid, lb) for fid, lb, _, blk in parts if blk is None]
        width = _decode_width(len(reads))
        if width > 1:
            with trace.span('loader.decode_batch'):
                filled = self._paste_pooled(out, parts, reads, width)
        else:
            filled = False
            for fid, lb, at, blk in parts:
                if blk is None:
                    blk = self._decode_tile_local(fid, lb)
                filled = _paste_block(out, blk, at) or filled
        if not filled and return_empty:
            return None
        return out

    def _paste_pooled(self, out, parts, reads, width):
        """Paste parts into out in order, the tiles of reads decoded on the
        decode pool, at most width of them ahead of the paste; True where
        a block was pasted. A read's exception reaches the caller."""
        trace.count('loader.decode_batches')
        pool = decode_pool()
        reads = iter(reads)
        inflight = deque()

        def submit():
            r = next(reads, None)
            if r is not None:
                inflight.append(pool.submit(self._decode_tile_local, *r))
        for _ in range(width):
            submit()
        filled = False
        try:
            for _, _, at, blk in parts:
                if blk is None:
                    blk = inflight.popleft().result()
                    trace.count('loader.batched_decodes')
                    submit()
                filled = _paste_block(out, blk, at) or filled
        finally:
            for f in inflight:
                f.cancel()
            futures.wait(inflight)
        return filled

    def to_dict(self):
        d = super().to_dict()
        d.update({'imgpaths': self.imgpaths, 'bboxes': self.bboxes.tolist(),
                  'root_dir': self.root_dir,
                  'cache_border_margin': self._cache_border_margin})
        return d


MosaicLoader = StaticImageLoader  # mosaic composition is built into crop()


def parse_pattern_filename(fname, pattern, tile_size):
    """World bbox of a tile from its filename (reference
    _filename_parser: dal.py:946-1006).

    ``pattern`` is a regex whose capture groups contain keyword markers
    ``{ROW_IND} {COL_IND} {X_MIN} {Y_MIN} {X_MAX} {Y_MAX}`` (markers are
    stripped before matching; group order follows marker position). Row/
    col indices scale by ``tile_size``; explicit min/max coordinates are
    used directly, with the missing side inferred from tile_size.
    """
    import re
    keywords = ('{ROW_IND}', '{COL_IND}', '{X_MIN}', '{Y_MIN}',
                '{X_MAX}', '{Y_MAX}')
    found = sorted((pattern.find(kw), kw) for kw in keywords
                   if pattern.find(kw) >= 0)
    used = [kw for _, kw in found]
    clean = pattern
    for kw in used:
        clean = clean.replace(kw, '')
    m = re.search(clean, fname)
    if m is None:
        raise RuntimeError(
            f'filename {fname!r} does not match pattern {clean!r}')
    vals = {kw: int(g) for kw, g in zip(used, m.groups())}
    th, tw = int(tile_size[0]), int(tile_size[-1])
    if '{X_MIN}' in vals:
        xmin = vals['{X_MIN}']
        xmax = vals.get('{X_MAX}', xmin + tw)
    elif '{X_MAX}' in vals:
        xmax = vals['{X_MAX}']
        xmin = xmax - tw
    elif '{COL_IND}' in vals:
        xmin = vals['{COL_IND}'] * tw
        xmax = xmin + tw
    else:
        raise RuntimeError(f'x position not defined in filename {fname}')
    if '{Y_MIN}' in vals:
        ymin = vals['{Y_MIN}']
        ymax = vals.get('{Y_MAX}', ymin + th)
    elif '{Y_MAX}' in vals:
        ymax = vals['{Y_MAX}']
        ymin = ymax - th
    elif '{ROW_IND}' in vals:
        ymin = vals['{ROW_IND}'] * th
        ymax = ymin + th
    else:
        raise RuntimeError(f'y position not defined in filename {fname}')
    return (xmin, ymin, xmax, ymax)


class TileView:
    """A view of one indexed tile in its own pixel frame (origin at the
    tile's corner), exposing the loader crop API. Used when sampling a
    tile through a mesh whose INITIAL gear is tile-local."""

    def __init__(self, loader, fileid):
        self._loader = loader
        self._fileid = int(fileid)
        self._origin = loader.bboxes[self._fileid, :2]

    @property
    def dtype(self):
        return self._loader.dtype

    @property
    def default_fillval(self):
        return self._loader.default_fillval

    @property
    def number_of_channels(self):
        return self._loader.number_of_channels

    def crop(self, bbox, return_empty=False, **kwargs):
        world = (bbox[0] + self._origin[0], bbox[1] + self._origin[1],
                 bbox[2] + self._origin[0], bbox[3] + self._origin[1])
        return self._loader.crop(world, fileid=self._fileid,
                                 return_empty=return_empty, **kwargs)


class StreamLoader(AbstractImageLoader):
    """Wraps an in-memory array (reference: dal.py:1008)."""

    def __init__(self, img, offset=(0, 0), **kwargs):
        super().__init__(**kwargs)
        self._img = np.asarray(img)
        self._offset = np.asarray(offset, np.float64)
        if self._dtype is None:
            self._dtype = self._img.dtype.name
        if self._number_of_channels is None:
            self._number_of_channels = 1 if self._img.ndim == 2 else self._img.shape[-1]

    @property
    def bbox(self):
        h, w = self._img.shape[:2]
        return (self._offset[0], self._offset[1],
                self._offset[0] + w, self._offset[1] + h)

    def crop(self, bbox, return_empty=False, **kwargs):
        img = self.preprocess(self._img)
        return _paste_crop(self._blank(bbox, kwargs.get('fillval')), bbox, img,
                           self.bbox, return_empty=return_empty)

    def to_dict(self):
        raise NotImplementedError('StreamLoader holds raw memory; not serializable')


def _ts_retrying(op, reconnect, retries=None, timeout=None):
    """Run a tensorstore op with timeout + reconnect retries (reference
    retry/reconnect: dal.py:1207-1241). ``op`` returns a tensorstore
    Future; reconnect() drops the dataset handle so the next attempt
    reopens the connection."""
    from feabas_tpu_torch import config as _config
    retries = _config.TS_RETRY if retries is None else int(retries)
    timeout = _config.ts_timeout() if timeout is None else float(timeout)
    err = None
    for attempt in range(retries + 1):
        try:
            return op().result(timeout=timeout)
        except (TimeoutError, Exception) as e:  # ts raises its own types
            if type(e).__name__ not in ('TimeoutError', 'DeadlineExceeded',
                                        'Unavailable', 'Aborted'):
                # only transient classes retry; real errors surface
                if not isinstance(e, TimeoutError):
                    raise
            err = e
            reconnect()
    raise TimeoutError(f'tensorstore op failed after {retries + 1} '
                       f'attempts: {err!r}')


class TensorStoreLoader(AbstractImageLoader):
    """Chunked-volume loader over tensorstore with timeout/reconnect
    retries on transient failures (reference: dal.py:1156,1207)."""

    def __init__(self, spec=None, dataset=None, z=0, **kwargs):
        # cache_capacity (MiB) caps the tensorstore cache pool
        # (reference: dal.py:1182-1183)
        cap = kwargs.get('cache_capacity', None)
        if cap is not None and spec is not None and 'context' not in spec:
            spec = dict(spec)
            spec['context'] = {'cache_pool': {
                'total_bytes_limit': int(cap * 2 ** 20)}}
        super().__init__(**kwargs)
        self._spec = spec
        self._z = int(z)
        self._dataset = dataset

    @property
    def dataset(self):
        if self._dataset is None:
            self._dataset = ts.open(self._spec).result()
        return self._dataset

    def reconnect(self):
        """Drop the connection; the next access reopens (reference:
        dal.py:1207)."""
        self._dataset = None

    def crop(self, bbox, return_empty=False, **kwargs):
        ds = self.dataset
        x0, y0, x1, y1 = [int(round(v)) for v in bbox]
        dom = ds.domain
        xi = dom[0].inclusive_min, dom[0].exclusive_max
        yi = dom[1].inclusive_min, dom[1].exclusive_max
        cx0, cx1 = max(x0, xi[0]), min(x1, xi[1])
        cy0, cy1 = max(y0, yi[0]), min(y1, yi[1])
        out = self._blank(bbox, kwargs.get('fillval'))
        if cx0 >= cx1 or cy0 >= cy1:
            return None if return_empty else out

        def read():
            ds_now = self.dataset
            if ds_now.rank == 4:
                return ds_now[cx0:cx1, cy0:cy1, self._z, 0].read()
            elif ds_now.rank == 3:
                return ds_now[cx0:cx1, cy0:cy1, self._z].read()
            return ds_now[cx0:cx1, cy0:cy1].read()

        blk = _ts_retrying(read, self.reconnect,
                           retries=kwargs.get('ts_retry'),
                           timeout=kwargs.get('ts_timeout'))
        blk = np.swapaxes(np.asarray(blk), 0, 1)  # ts is x-major; images y-major
        out[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0] = self.preprocess(blk)
        return out

    def to_dict(self):
        d = super().to_dict()
        d.update({'spec': self._spec, 'z': self._z})
        return d


def _paste_crop(out, bbox, img, img_bbox, return_empty=False):
    """Paste the part of img (located at img_bbox) visible in bbox into out."""
    x0, y0 = int(round(bbox[0])), int(round(bbox[1]))
    # far corner from the same integerization as the canvas shape (see
    # StaticImageLoader._tile_window)
    x1 = x0 + int(round(bbox[2] - bbox[0]))
    y1 = y0 + int(round(bbox[3] - bbox[1]))
    ix0, iy0 = int(round(img_bbox[0])), int(round(img_bbox[1]))
    h, w = img.shape[:2]
    cx0, cx1 = max(x0, ix0), min(x1, ix0 + w)
    cy0, cy1 = max(y0, iy0), min(y1, iy0 + h)
    if cx0 >= cx1 or cy0 >= cy1:
        return None if return_empty else out
    out[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0] = \
        img[cy0 - iy0:cy1 - iy0, cx0 - ix0:cx1 - ix0]
    return out


_LOADER_TYPES = {}
for _cls in (DynamicImageLoader, StaticImageLoader, StreamLoader, TensorStoreLoader):
    _LOADER_TYPES[_cls.__name__] = _cls
_LOADER_TYPES['MosaicLoader'] = StaticImageLoader


def get_loader_from_json(spec, **kwargs):
    """Factory from a dict / JSON string / JSON file path
    (reference: dal.py:88)."""
    if isinstance(spec, AbstractImageLoader):
        return spec
    if isinstance(spec, str):
        if spec.lstrip().startswith('{'):
            spec = json.loads(spec)
        else:
            with storage.File(spec, 'r') as f:
                spec = json.load(f)
    spec = dict(spec)
    spec.update(kwargs)
    loader_type = spec.pop('loader_type', 'StaticImageLoader')
    cls = _LOADER_TYPES[loader_type]
    if cls is StaticImageLoader:
        return cls(spec.pop('imgpaths'), spec.pop('bboxes'),
                   root_dir=spec.pop('root_dir', None), **spec)
    if cls is TensorStoreLoader:
        return cls(spec.pop('spec'), z=spec.pop('z', 0), **spec)
    return cls(**spec)


class TensorStoreWriter:
    """Chunk-aligned writer for 3D output volumes
    (reference: dal.py:1367-1538).

    Supports neuroglancer_precomputed / zarr / n5 through ``ts`` (without
    tensorstore: unsharded neuroglancer_precomputed only). The volume frame
    is (x, y, z[, channel]); images are (y, x) so writes transpose. Chunk
    grid helpers + Morton ordering drive render planning.
    """

    def __init__(self, spec, dataset=None):
        self._spec = spec
        self._dataset = dataset

    @classmethod
    def create(cls, out_dir, canvas_bbox, num_sections, **kwargs):
        driver = kwargs.get('driver', 'neuroglancer_precomputed')
        chunk_shape = list(kwargs.get('chunk_shape', (2048, 2048, 16)))
        resolution = kwargs.get('resolution', 4)
        thickness = kwargs.get('thickness', 30)
        dtype = np.dtype(kwargs.get('dtype', 'uint8'))
        jpeg = kwargs.get('jpeg_compression', False)
        x0, y0, x1, y1 = (int(v) for v in canvas_bbox)
        size = [x1 - x0, y1 - y0, int(num_sections)]
        kv = {'driver': 'file', 'path': str(out_dir)} \
            if not storage.is_cloud_path(str(out_dir)) else \
            {'driver': 'gcs', 'bucket': str(out_dir)[5:].split('/')[0],
             'path': '/'.join(str(out_dir)[5:].split('/')[1:])}
        read_chunk = kwargs.get('read_chunk_shape', None)
        if driver == 'neuroglancer_precomputed':
            spec = {
                'driver': driver, 'kvstore': kv,
                'scale_metadata': {
                    'size': size,
                    'resolution': [resolution, resolution, thickness],
                    'encoding': 'jpeg' if jpeg else 'raw'},
                'multiscale_metadata': {'data_type': dtype.name,
                                        'num_channels': 1, 'type': 'image'},
                'create': True, 'open': True,
            }
            if read_chunk and list(read_chunk) != list(chunk_shape):
                # sharded format: small read chunks inside big write
                # shards (reference schema: stitcher.py:1680-1686)
                spec['schema'] = {'chunk_layout': {
                    'grid_origin': [0, 0, 0, 0],
                    'inner_order': [3, 2, 1, 0],
                    'read_chunk': {'shape_soft_constraint':
                                   [int(v) for v in read_chunk] + [1]},
                    'write_chunk': {'shape_soft_constraint':
                                    [int(v) for v in chunk_shape] + [1]},
                }}
            else:
                spec['scale_metadata']['chunk_size'] = chunk_shape
        elif driver in ('zarr', 'n5'):
            spec = {
                'driver': driver, 'kvstore': kv,
                'metadata': ({'shape': size, 'chunks': chunk_shape,
                              'dtype': dtype.str} if driver == 'zarr' else
                             {'dimensions': size, 'blockSize': chunk_shape,
                              'dataType': dtype.name}),
                'create': True, 'open': True,
            }
        else:
            raise ValueError(f'unsupported volume driver {driver}')
        w = cls(spec)
        w._offset = (x0, y0)
        w._chunk_shape = chunk_shape
        w._size = size
        # materialize the store eagerly: later (re-)opens, including in
        # pickled worker copies, are open-only, so workers never race on
        # creation
        w._dataset = ts.open(spec).result()
        return w

    @property
    def dataset(self):
        if self._dataset is None:
            spec = dict(self._spec)
            # workers open an existing store; never re-create (races)
            if spec.pop('create', False):
                spec['open'] = True
            self._dataset = ts.open(spec).result()
        return self._dataset

    def __getstate__(self):
        # picklable across process workers: the open handle re-opens lazily
        state = dict(self.__dict__)
        state['_dataset'] = None
        return state

    @property
    def offset(self):
        return getattr(self, '_offset', (0, 0))

    @property
    def chunk_shape(self):
        return getattr(self, '_chunk_shape', None) or \
            list(self.dataset.chunk_layout.read_chunk.shape[:3])

    @property
    def size(self):
        return getattr(self, '_size', None) or \
            [int(d.exclusive_max) for d in self.dataset.domain][:3]

    def plan_chunks(self, bbox=None):
        """Morton-ordered write-chunk bboxes (world xy) covering bbox."""
        from feabas_tpu_torch.common import z_order
        cx, cy = self.chunk_shape[0], self.chunk_shape[1]
        x0, y0 = self.offset
        W, H = self.size[0], self.size[1]
        if bbox is None:
            bbox = (x0, y0, x0 + W, y0 + H)
        i0 = max(int((bbox[0] - x0) // cx), 0)
        i1 = min(int(np.ceil((bbox[2] - x0) / cx)), int(np.ceil(W / cx)))
        j0 = max(int((bbox[1] - y0) // cy), 0)
        j1 = min(int(np.ceil((bbox[3] - y0) / cy)), int(np.ceil(H / cy)))
        if i1 <= i0 or j1 <= j0:
            return []
        ii, jj = np.meshgrid(np.arange(i0, i1), np.arange(j0, j1))
        ij = np.stack([ii.ravel(), jj.ravel()], -1)
        ij = ij[z_order(ij)]
        out = []
        for i, j in ij:
            bx0 = x0 + i * cx
            by0 = y0 + j * cy
            out.append((bx0, by0, min(bx0 + cx, x0 + W), min(by0 + cy, y0 + H)))
        return out

    def reconnect(self):
        """Drop the handle; next access reopens (reference: dal.py:1207)."""
        self._dataset = None

    def _count_write(self, box):
        """Count one store write of ``box`` [(lo, hi)] over (x, y, z), and
        whether it covers part of a storage chunk's extent (a store
        read-modify-writes such a chunk)."""
        trace.count('volume.chunk_writes')
        for (lo, hi), c, n in zip(box, self.chunk_shape, self.size):
            if lo % c or (hi % c and hi != n):
                trace.count('volume.partial_writes')
                return

    @trace.spanned('volume.write')
    def write_single_chunk(self, bbox, z, img, txn=None, ts_retry=None):
        """Write one (y, x) image block at world bbox into section z, with
        timeout/reconnect retries (reference: dal.py:1372,1207)."""
        x0, y0 = self.offset
        a = int(bbox[0] - x0)
        b = int(bbox[1] - y0)
        c = a + img.shape[1]
        d = b + img.shape[0]
        self._count_write([(a, c), (b, d), (int(z), int(z) + 1)])
        blk = np.ascontiguousarray(np.swapaxes(img, 0, 1))

        def write():
            ds = self.dataset
            if txn is not None:
                ds = ds.with_transaction(txn)
            if self.dataset.rank == 4:
                return ds[a:c, b:d, int(z), 0].write(blk)
            return ds[a:c, b:d, int(z)].write(blk)

        if txn is not None:
            # inside a transaction the commit carries the retry semantics
            write().result()
            return
        _ts_retrying(write, self.reconnect, retries=ts_retry)

    @trace.spanned('volume.write')
    def write_chunks_w_transaction(self, bboxes, z, imgs, ts_retry=None):
        """Atomically write several chunks in one transaction, retried with
        reconnect on transient failure (reference: dal.py:1429)."""
        if len(bboxes) == 1:
            self.write_single_chunk(bboxes[0], z, imgs[0], ts_retry=ts_retry)
            return
        from feabas_tpu_torch.config import TS_RETRY, TS_TIMEOUT
        retries = TS_RETRY if ts_retry is None else int(ts_retry)
        err = None
        for attempt in range(retries + 1):
            try:
                txn = ts.Transaction()
                for bbox, img in zip(bboxes, imgs):
                    self.write_single_chunk(bbox, z, img, txn=txn)
                txn.commit_async().result(timeout=TS_TIMEOUT)
                if not txn.aborted:
                    return
            except (TimeoutError, Exception) as e:
                if not isinstance(e, TimeoutError) and type(e).__name__ not in (
                        'DeadlineExceeded', 'Unavailable', 'Aborted'):
                    raise
                err = e
                self.reconnect()
        raise TimeoutError(f'transactional write failed after '
                           f'{retries + 1} attempts: {err!r}')

    @trace.spanned('volume.write')
    def write_slab(self, bbox, z0, stack, ts_retry=None):
        """Write a slab block in ONE write.

        ``stack`` is (dz, H, W): the same xy chunk across consecutive
        sections z0..z0+dz. Writing whole-depth slabs means each
        (chunk-depth-deep) storage chunk is touched exactly once instead
        of read-modify-written per section (reference plan_one_slab:
        renderer.py:1009-1103); a stack over part of a chunk's depth
        leaves its other layers as stored."""
        x0, y0 = self.offset
        a = int(bbox[0] - x0)
        b = int(bbox[1] - y0)
        c = a + stack.shape[2]
        d = b + stack.shape[1]
        z1 = int(z0) + stack.shape[0]
        self._count_write([(a, c), (b, d), (int(z0), z1)])
        blk = np.ascontiguousarray(np.transpose(stack, (2, 1, 0)))

        def write():
            ds = self.dataset
            if ds.rank == 4:
                return ds[a:c, b:d, int(z0):z1, 0].write(blk)
            return ds[a:c, b:d, int(z0):z1].write(blk)

        _ts_retrying(write, self.reconnect, retries=ts_retry)

    def read_chunk(self, bbox, z):
        x0, y0 = self.offset
        a, b = int(bbox[0] - x0), int(bbox[1] - y0)
        c, d = int(bbox[2] - x0), int(bbox[3] - y0)
        ds = self.dataset
        blk = ds[a:c, b:d, int(z), 0] if ds.rank == 4 else ds[a:c, b:d, int(z)]
        return np.swapaxes(np.asarray(blk.read().result()), 0, 1)

    def to_dict(self):
        return {'spec': self._spec, 'offset': list(self.offset),
                'chunk_shape': self.chunk_shape, 'size': self.size}

    @classmethod
    def from_dict(cls, d):
        w = cls(d['spec'])
        w._offset = tuple(d['offset'])
        w._chunk_shape = d['chunk_shape']
        w._size = d['size']
        return w


def get_tensorstore_spec(base_spec, mip=0):
    """Stack a 'downsample' driver to serve mip levels from a
    full-resolution volume (reference: dal.py:1125). Its factors cover
    every dimension of the base, as tensorstore requires: a
    neuroglancer-precomputed volume has four, the channel last (the JAX
    package's three factors fail on one, reference fault R3)."""
    spec = base_spec
    if mip > 0:
        rank = ts.open(base_spec).result().rank
        spec = {'driver': 'downsample',
                'downsample_factors': [2 ** mip, 2 ** mip] + [1] * (rank - 2),
                'downsample_method': 'mean',
                'base': base_spec}
    return spec
