"""Mipmap pyramids of stitched sections.

Downsamples tile mosaics level by level (2x per mip, area averaging),
writing each level as tiles + a metadata coordinate file so every level is
mosaic-loadable (capability parity with reference ``feabas/mipmap.py``).

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


