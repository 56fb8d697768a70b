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

from feabas_tpu_torch import common, storage
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
        # tensorstore-rendered section: its thumbnail comes straight from
        # the volume, which is not ported (raises)
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
    """Thumbnail straight from a tensorstore volume. Not ported: the GPU
    host has no tensorstore."""
    raise NotImplementedError(
        'feabas_tpu.mipmap.create_thumbnail_tensorstore (thumbnails of '
        'tensorstore-rendered sections) is not ported; the GPU host has no '
        'tensorstore')


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
