"""Mipmap pyramids and thumbnails from stitched sections.

Downsamples tile mosaics level by level (2x per mip, area averaging),
writing each level as tiles + a metadata coordinate file so every level is
mosaic-loadable; thumbnails are single images at a configurable mip with
optional high-pass contrast enhancement (capability parity with reference
``feabas/mipmap.py``).

The port's copy of ``feabas_tpu/mipmap.py``, cut to what the port reaches.
"""

import numpy as np
import cv2

from feabas_tpu_torch import common, dal, storage
from feabas_tpu_torch.dal import StaticImageLoader
from feabas_tpu_torch.storage import join_paths


def _mosaic_bbox(loader):
    b = loader.bboxes
    return (b[:, 0].min(), b[:, 1].min(), b[:, 2].max(), b[:, 3].max())


def get_image_loader(src_dir, pattern='_tr{ROW_IND}-tc{COL_IND}.png',
                     one_based=True, **kwargs):
    """Loader for a mosaic directory: uses ``metadata.txt`` when present,
    otherwise parses tile positions from the FILENAMES so foreign
    datasets without coordinate files still load (reference
    get_image_loader: mipmap.py:26-55)."""
    import os
    meta = join_paths(str(src_dir), 'metadata.txt')
    if storage.file_exists(meta):
        return StaticImageLoader.from_coordinate_file(meta, **kwargs)
    pattern0 = os.path.splitext(pattern)[0]
    pattern0 = pattern0.replace('{', '({').replace('}', r'}\d+)')
    tile_offset = (-1, -1) if one_based else None
    return StaticImageLoader.from_filepath(str(src_dir), pattern=pattern0,
                                           tile_offset=tile_offset,
                                           **kwargs)


def mip_one_level(meta_in, out_dir, tile_size=(4096, 4096), fmt='jpg',
                  pre_blur=0.75, num_workers=1, **loader_config):
    """Downsample one mip level by 2x (reference: mipmap.py:71).

    Reads the source mosaic via its metadata file, writes half-resolution
    tiles + metadata into ``out_dir``. ``pre_blur`` applies a Gaussian
    anti-alias filter before the 2x area average (the reference's render
    path pre-blurs; pure INTER_AREA on a 2x chain leaves measurable
    aliasing in the thumbnails that feed matching) — set 0 to disable.
    ``num_workers`` > 1 processes output tiles on a thread pool (the
    within-section parallelism of reference mip_map_one_section:131; cv2
    and image IO release the GIL). Returns the new metadata path."""
    meta_out = join_paths(out_dir, 'metadata.txt')
    if storage.file_exists(meta_out, use_cache=True):
        return meta_out
    if str(meta_in).endswith('.txt'):
        loader = StaticImageLoader.from_coordinate_file(meta_in,
                                                        **loader_config)
    else:
        # a bare tile directory: positions from filenames
        loader = get_image_loader(meta_in, **loader_config)
    x0, y0, x1, y1 = _mosaic_bbox(loader)
    # output frame = source/2
    ox0, oy0 = int(np.floor(x0 / 2)), int(np.floor(y0 / 2))
    ox1, oy1 = int(np.ceil(x1 / 2)), int(np.ceil(y1 / 2))
    th, tw = tile_size
    prefix = storage.base_name(storage.dir_name(meta_out)) or 'mip'

    def one_tile(tx, ty):
        bx1 = min(tx + tw, ox1)
        by1 = min(ty + th, oy1)
        src = loader.crop((tx * 2, ty * 2, bx1 * 2, by1 * 2),
                          return_empty=True)
        if src is None:
            return None
        if pre_blur and pre_blur > 0:
            src = cv2.GaussianBlur(src, (0, 0), float(pre_blur))
        img = cv2.resize(src, (bx1 - tx, by1 - ty),
                         interpolation=cv2.INTER_AREA)
        r = (ty - oy0) // th + 1
        c = (tx - ox0) // tw + 1
        fname = f'{prefix}_tr{r}-tc{c}.{fmt}'
        common.imwrite(join_paths(out_dir, fname), img)
        return (fname, tx, ty, bx1, by1)

    grid = [(tx, ty) for ty in range(oy0, oy1, th)
            for tx in range(ox0, ox1, tw)]
    if int(num_workers) > 1 and len(grid) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=int(num_workers)) as ex:
            rows = list(ex.map(lambda a: one_tile(*a), grid))
    else:
        rows = [one_tile(*a) for a in grid]
    rows = [r for r in rows if r is not None]
    res = (loader.resolution or 4) * 2
    with storage.File(meta_out, 'w') as f:
        f.write('{ROOT_DIR}\t' + str(out_dir) + '\n')
        f.write('{RESOLUTION}\t' + str(res) + '\n')
        for fname, a, b, c, d in rows:
            f.write(f'{fname}\t{a}\t{b}\t{c}\t{d}\n')
    return meta_out


def downsample_section_thumbnail(name, meta, work_dir, dconf, thumb_mip,
                                 fmt='png'):
    """One section's mip chain + thumbnail + material mask — the
    thumbnail-stage downsample worker (reference: thumbnail_main.py:446-506).
    Lives here (not in the driver script) so remote worker backends can
    import it. Returns ``name``."""
    out = join_paths(work_dir, 'thumbnail_align', 'thumbnails',
                     f'{name}.{fmt}')
    max_mip = int(dconf.get('max_mip', thumb_mip))
    if not str(meta).endswith('.txt'):
        # tensorstore-rendered section: thumbnail straight from the
        # volume via downsample views; mips are served virtually
        # (get_tensorstore_spec) so no tile pyramid is materialized
        create_thumbnail_tensorstore(
            meta, out, thumbnail_mip=thumb_mip,
            highpass=dconf.get('thumbnail_highpass', True),
            highpass_inter_mip=dconf.get('highpass_inter_mip_lvl', 4))
    else:
        nw = int(dconf.get('num_workers', 1) or 1) \
            if dconf.get('parallel_within_section', True) else 1
        mips = mip_map_one_section(name, meta,
                                   join_paths(work_dir, 'stitched_sections'),
                                   max_mip=min(max_mip, 4),
                                   fmt=dconf.get('format', 'jpg'),
                                   num_workers=nw)
        # thumbnail from the deepest useful mip of the pyramid just built,
        # not mip0: create_thumbnail loads its source whole, and a full-res
        # MultiSEM section is tens of GB (reference chains thumbnails off
        # the mip pyramid too, mipmap.py:161-231)
        hp = dconf.get('thumbnail_highpass', True)
        hp_mip = int(dconf.get('highpass_inter_mip_lvl', 4))
        src_lvl = min(max(mips), hp_mip if hp else thumb_mip, thumb_mip)
        create_thumbnail(
            mips[src_lvl], out, thumbnail_mip=thumb_mip, src_mip=src_lvl,
            highpass=hp, highpass_inter_mip=hp_mip)
    tform = join_paths(work_dir, 'stitch', 'tform', name + '.h5')
    if storage.file_exists(tform):
        generate_thumbnail_mask(
            tform,
            join_paths(work_dir, 'thumbnail_align', 'material_masks',
                       name + '.png'),
            thumbnail_mip=thumb_mip,
            mask_erode=dconf.get('mask_erode', 2))
    return name


def mip_map_one_section(sec_name, src_meta, out_root, max_mip=7, fmt='jpg',
                        **loader_config):
    """Chain mip levels 1..max_mip for one section
    (reference: mipmap.py:131). Returns {mip: metadata_path}."""
    out = {0: src_meta}
    meta = src_meta
    for lvl in range(1, max_mip + 1):
        out_dir = join_paths(out_root, f'mip{lvl}', sec_name)
        meta = mip_one_level(meta, out_dir, fmt=fmt, **loader_config)
        out[lvl] = meta
    return out


def _max_entropy_scaling(img, qlow=0.01, qhigh=0.99):
    """Histogram auto-scaling to uint8 (reference uses entropy-driven
    scaling, mipmap.py:283-331; quantile clipping is its robust core)."""
    v = img[np.isfinite(img)]
    if v.size == 0:
        return np.zeros_like(img, dtype=np.uint8)
    lo, hi = np.quantile(v, [qlow, qhigh])
    if hi <= lo:
        hi = lo + 1
    out = (img - lo) / (hi - lo) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def create_thumbnail(src_meta, out_file, thumbnail_mip=6, src_mip=0,
                     highpass=True, highpass_inter_mip=4, **loader_config):
    """One thumbnail image for a section (reference: mipmap.py:161).

    With ``highpass``, the image is downsampled to an intermediate mip,
    band-passed (unsharp) to suppress large-scale shading, then reduced to
    the target mip and auto-scaled.
    """
    if storage.file_exists(out_file, use_cache=True):
        return out_file
    loader = StaticImageLoader.from_coordinate_file(src_meta, **loader_config)
    x0, y0, x1, y1 = (int(v) for v in _mosaic_bbox(loader))
    img = loader.crop((x0, y0, x1, y1)).astype(np.float32)
    scale_total = 2 ** (thumbnail_mip - src_mip)
    if highpass and highpass_inter_mip < thumbnail_mip:
        s1 = 2 ** (highpass_inter_mip - src_mip)
        mid = cv2.resize(img, (max(img.shape[1] // s1, 1),
                               max(img.shape[0] // s1, 1)),
                         interpolation=cv2.INTER_AREA)
        blur = cv2.GaussianBlur(mid, (0, 0), 8)
        mid = mid - blur
        s2 = scale_total // s1
        thumb = cv2.resize(mid, (max(mid.shape[1] // s2, 1),
                                 max(mid.shape[0] // s2, 1)),
                           interpolation=cv2.INTER_AREA)
    else:
        thumb = cv2.resize(img, (max(img.shape[1] // scale_total, 1),
                                 max(img.shape[0] // scale_total, 1)),
                           interpolation=cv2.INTER_AREA)
    common.imwrite(out_file, _max_entropy_scaling(thumb))
    return out_file


def tensorstore_spec_for_dir(path):
    """Detect the tensorstore driver of a rendered-volume directory and
    return an openable spec, or None when the directory is not a volume."""
    markers = (('info', 'neuroglancer_precomputed'),
               ('.zarray', 'zarr'), ('.zgroup', 'zarr'),
               ('attributes.json', 'n5'))
    for fname, driver in markers:
        if storage.file_exists(join_paths(str(path), fname)):
            return {'driver': driver,
                    'kvstore': {'driver': 'file', 'path': str(path)}}
    return None


def create_thumbnail_tensorstore(base_spec, out_file=None, thumbnail_mip=6,
                                 z=0, highpass=True,
                                 highpass_inter_mip=None):
    """Thumbnail straight from a volume through stacked 'downsample'
    views (reference create_thumbnail_tensorstore: mipmap.py:252): no
    intermediate mip tiles touch disk.

    With ``highpass``, shading is suppressed by the reference's
    max-minus-min construction: mean-downsample to an intermediate mip,
    then take one extra level of MAX- and MIN-downsampling (cast to
    float), mean-reduce both to the target mip, and auto-scale their
    difference (dark-on-light, matching the image-path thumbnails).
    """
    if out_file is not None and storage.file_exists(out_file,
                                                    use_cache=True):
        return out_file
    from feabas_tpu_torch.dal import TensorStoreLoader, get_tensorstore_spec
    if isinstance(base_spec, str):
        spec = tensorstore_spec_for_dir(base_spec)
        if spec is None:
            raise RuntimeError(f'not a tensorstore volume: {base_spec}')
        base_spec = spec

    def read_full(spec):
        ld = TensorStoreLoader(spec, z=z)
        dom = ld.dataset.domain
        b = (int(dom[0].inclusive_min), int(dom[1].inclusive_min),
             int(dom[0].exclusive_max), int(dom[1].exclusive_max))
        return ld.crop(b)

    if not highpass:
        img = read_full(get_tensorstore_spec(base_spec, mip=thumbnail_mip))
        out = _max_entropy_scaling(img.astype(np.float32))
    else:
        inter = max(0, thumbnail_mip - 2) if highpass_inter_mip is None \
            else int(highpass_inter_mip)
        inter = min(inter, max(thumbnail_mip - 1, 0))
        inter_spec = get_tensorstore_spec(base_spec, mip=inter)
        rest = thumbnail_mip - inter - 1
        rank = dal.ts.open(base_spec).result().rank
        ext = {}
        for method in ('max', 'min'):
            s = {'driver': 'cast', 'dtype': 'float32',
                 'base': {'driver': 'downsample',
                          'downsample_factors': [2, 2] + [1] * (rank - 2),
                          'downsample_method': method,
                          'base': inter_spec}}
            ext[method] = read_full(get_tensorstore_spec(s, mip=rest))
        hp = ext['max'].astype(np.float32) - ext['min'].astype(np.float32)
        out = 255 - _max_entropy_scaling(hp, qlow=0.0)
    if out_file is None:
        return out
    common.imwrite(out_file, out)
    return out_file


def generate_thumbnail_mask(tform_h5, out_file, thumbnail_mip=6,
                            mask_erode=2, device=None):
    """ROI mask for a section's thumbnail from its stitch meshes
    (reference: thumbnail_main.py:155): rasterize the solved tile meshes at
    thumbnail resolution; non-covered pixels get the exclude label."""
    if storage.file_exists(out_file, use_cache=True):
        return out_file
    from feabas_tpu_torch.device import get_device
    from feabas_tpu_torch.stitcher import Stitcher
    from feabas_tpu_torch.renderer import rasterize_mesh
    st = Stitcher.from_h5(tform_h5, load_matches=False, load_meshes=True,
                          device=get_device(device))
    scale = 1.0 / (2 ** thumbnail_mip)
    boxes = np.asarray([m.bbox(gear='MOVING') for m in st.meshes])
    x1 = int(np.ceil(boxes[:, 2].max() * scale)) + 1
    y1 = int(np.ceil(boxes[:, 3].max() * scale)) + 1
    mask = np.full((y1, x1), 255, np.uint8)   # exclude label
    for m in st.meshes:
        mm = m.copy()
        mm.change_resolution(mm.resolution / scale)
        tid = rasterize_mesh(mm, (0, 0, x1, y1), gear='MOVING')
        mask[tid >= 0] = 0                    # default material
    if mask_erode > 0:
        k = np.ones((3, 3), np.uint8)
        roi = (mask == 0).astype(np.uint8)
        roi = cv2.erode(roi, k, iterations=int(mask_erode))
        mask = np.where(roi > 0, 0, 255).astype(np.uint8)
    common.imwrite(out_file, mask)
    return out_file


def mip_one_level_tensorstore_3d(src_dir, out_dir, mip_levels=(1, 3, 5, 7),
                                 downsample_z='auto', z_range=None,
                                 logger=None, chunk=1024,
                                 keep_chunk_layout=True, cache_capacity=None,
                                 jpeg_compression=None, **_ignored):
    """Generate lower-resolution scales of a 3D neuroglancer-precomputed
    volume (reference: mipmap.py:434). xy downsampling is mean-pooled; z
    follows 'auto' (downsample z to keep voxels near-isotropic) or an
    explicit list. ``keep_chunk_layout`` reuses the source volume's chunk
    shape for the output scales (reference: mipmap.py:436,481);
    ``cache_capacity`` caps the read-side tensorstore cache pool in MiB
    (the port's own store keeps no cache). Returns the number of scales
    written."""
    base_spec = {'driver': 'neuroglancer_precomputed',
                 'kvstore': {'driver': 'file', 'path': str(src_dir)}}
    if cache_capacity:
        base_spec = dict(base_spec)
        base_spec['context'] = {'cache_pool': {
            'total_bytes_limit': int(cache_capacity * 2 ** 20)}}
    src = dal.ts.open(base_spec).result()
    src_chunk = list(src.chunk_layout.read_chunk.shape[:3])
    if jpeg_compression is None:
        # None -> inherit the source volume's encoding so one multiscale
        # volume stays consistently encoded
        enc = src.spec().to_json().get('scale_metadata', {}).get('encoding')
        jpeg_compression = (enc == 'jpeg')
    size = [int(d) for d in src.shape[:3]]
    dims = src.spec().to_json().get('scale_metadata', {})
    res = dims.get('resolution', [4, 4, 30])
    n_done = 0
    for mip in mip_levels:
        fxy = 2 ** int(mip)
        if downsample_z == 'auto':
            # keep z no finer than xy
            fz = max(int((res[0] * fxy) // res[2]), 1)
        elif isinstance(downsample_z, (list, tuple)):
            fz = int(downsample_z[list(mip_levels).index(mip)])
        else:
            fz = int(downsample_z)
        fz = min(fz, size[2]) or 1
        ds_spec = {'driver': 'downsample',
                   'downsample_factors': [fxy, fxy, fz, 1][:src.rank],
                   'downsample_method': 'mean',
                   'base': base_spec}
        ds = dal.ts.open(ds_spec).result()
        out_size = [int(d) for d in ds.shape[:3]]
        if keep_chunk_layout:
            chunk_size = [min(int(c), int(s))
                          for c, s in zip(src_chunk, out_size)]
        else:
            chunk_size = [min(chunk, out_size[0]), min(chunk, out_size[1]),
                          min(16, out_size[2])]
        out_spec = {
            'driver': 'neuroglancer_precomputed',
            'kvstore': {'driver': 'file', 'path': str(out_dir)},
            'scale_metadata': {
                'size': out_size,
                'resolution': [res[0] * fxy, res[1] * fxy, res[2] * fz],
                'chunk_size': chunk_size,
                'encoding': 'jpeg' if jpeg_compression else 'raw'},
            'multiscale_metadata': {
                'data_type': str(np.dtype(src.dtype.name)),
                'num_channels': 1, 'type': 'image'},
            'create': True, 'open': True,
        }
        out = dal.ts.open(out_spec).result()
        zs = range(out_size[2]) if z_range is None else range(*z_range)
        for z in zs:
            for x0 in range(0, out_size[0], chunk):
                for y0 in range(0, out_size[1], chunk):
                    x1 = min(x0 + chunk, out_size[0])
                    y1 = min(y0 + chunk, out_size[1])
                    if src.rank == 4:
                        blk = ds[x0:x1, y0:y1, z, :].read().result()
                        out[x0:x1, y0:y1, z, :] = blk
                    else:
                        blk = ds[x0:x1, y0:y1, z].read().result()
                        out[x0:x1, y0:y1, z] = blk
        n_done += 1
        if logger:
            logger.info(f'tsd: mip{mip} ({fxy}x{fxy}x{fz}) -> {out_size}')
    return n_done
