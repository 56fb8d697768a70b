"""Thumbnail CLI of the PyTorch port: downsample -> matching -> optimization
-> render, with the flags and work-dir protocol of scripts/thumbnail_main.py.

    python -m feabas_tpu_torch.scripts.thumbnail_main --mode downsample|matching|optimization|render|alignment
                             [--start S --stop E --step K --reverse]

Work-dir protocol: mipmaps to ``stitched_sections/mip{n}``, thumbnails to
``thumbnail_align/thumbnails``, coarse matches to
``thumbnail_align/matches``, thumbnail meshes/transforms to
``thumbnail_align/{mesh,tform}``. Long-range anchor pairs may be listed in
``thumbnail_align/match_name.txt`` (one 'sec0 sec1' per line);
``section_order.txt`` in the work dir reorders sections; ``alignment``
chains matching, optimization and render. The compute device comes from
FEABAS_TORCH_DEVICE (the CUDA card when unset; 'cpu' runs on the CPU).
A section rendered into a volume gets its thumbnail straight from the
volume (``mipmap.create_thumbnail_tensorstore``).
"""

import argparse

import numpy as np

from feabas_tpu_torch import config, storage
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch.common import unique_prefix_arg
from feabas_tpu_torch.logging import (initialize_main_logger, stage_timer,
                                      terminate_logger)
from feabas_tpu_torch.scripts.align_main import \
    stitched_section_list as stitched_sections
from feabas_tpu_torch.storage import join_paths


def thumb_path(work_dir, name, fmt='png'):
    return join_paths(work_dir, 'thumbnail_align', 'thumbnails',
                      f'{name}.{fmt}')


def downsample_main(args, conf, logger):
    """``parallel_within_section`` (reference: thumbnail_main.py:14,21)
    keeps the section loop serial — the per-section path owns the
    workers/device; False fans whole sections across process workers."""
    work_dir = config.get_work_dir()
    dconf = conf.get('downsample', {})
    thumb_mip = int(conf.get('thumbnail_mip_level', 6))
    fmt = dconf.get('thumbnail_format', 'png')
    num_workers = int(dconf.get('num_workers', 1) or 1)
    within = bool(dconf.get('parallel_within_section', True))
    from feabas_tpu_torch.mipmap import downsample_section_thumbnail
    pairs = list(stitched_sections(work_dir, args))
    if within or num_workers <= 1:
        for name, meta in pairs:
            with stage_timer(None, 'thumbnail.downsample.section') as timer:
                downsample_section_thumbnail(name, meta, work_dir, dconf,
                                             thumb_mip, fmt)
                logger.info(f'{name}: downsampled in {timer.elapsed:.1f}s')
    else:
        # worker lives in the mipmap module so remote backends (slurm
        # spool) can import it — script-local functions are rejected
        from feabas_tpu_torch.concurrent import submit_to_workers
        jobs = [(n, m, work_dir, dict(dconf), thumb_mip, fmt)
                for n, m in pairs]
        for name in submit_to_workers(downsample_section_thumbnail, jobs,
                                      num_workers=num_workers):
            logger.info(f'{name}: downsampled')


def _pair_list(names, compare_distance, work_dir):
    pairs = []
    for d in range(1, int(compare_distance) + 1):
        pairs += [(names[i], names[i + d]) for i in range(len(names) - d)]
    anchor_file = join_paths(work_dir, 'thumbnail_align', 'match_name.txt')
    if storage.file_exists(anchor_file):
        with storage.File(anchor_file, 'r') as f:
            for line in f:
                t = line.split()
                if len(t) >= 2 and (t[0], t[1]) not in pairs:
                    pairs.append((t[0], t[1]))
    return pairs


def matching_main(args, conf, logger):
    from feabas_tpu_torch.thumbnail import align_two_thumbnails, prepare_image
    from feabas_tpu_torch.aligner import save_matches_to_h5, match_name
    from feabas_tpu_torch.common import imread
    from feabas_tpu_torch.caching import generate_cache
    import cv2
    work_dir = config.get_work_dir()
    aconf = dict(conf.get('alignment', {}) or {})
    thumb_mip = int(conf.get('thumbnail_mip_level', 6))
    res = config.montage_resolution() * (2 ** thumb_mip)
    fmt = conf.get('downsample', {}).get('thumbnail_format', 'png')
    names = [n for n, _ in stitched_sections(work_dir, None)]
    # section_order.txt defines z-neighborhood for pair generation
    # (reference: thumbnail_main.py:444,513)
    from feabas_tpu_torch.common import rearrange_section_order
    names, _ = rearrange_section_order(
        names, join_paths(work_dir, 'section_order.txt'))
    pairs = _pair_list(names, aconf.get('compare_distance', 2), work_dir)
    if args.reverse:
        pairs = pairs[::-1]
    pairs = pairs[slice(args.start, args.stop, args.step)]
    out_dir = join_paths(work_dir, 'thumbnail_align', 'matches')
    mask_dir = join_paths(work_dir, 'thumbnail_align', 'material_masks')
    cache = generate_cache('lru', maxlen=aconf.get('cache_size', 3) * 2)
    for sec0, sec1 in pairs:
        out = join_paths(out_dir, match_name(
            sec0, sec1, aconf.get('match_name_delimiter', '__to__')))
        if storage.file_exists(out, use_cache=True):
            continue
        with stage_timer(None, 'thumbnail.matching.pair') as timer:

            def load(name):
                if name in cache:
                    return cache[name]
                img = imread(thumb_path(work_dir, name, fmt), flag=cv2.IMREAD_GRAYSCALE)
                mfile = join_paths(mask_dir, name + '.png')
                mask = None
                if storage.file_exists(mfile):
                    mask = imread(mfile, flag=cv2.IMREAD_GRAYSCALE) != 255
                    if mask.shape != img.shape:
                        # the mask and the thumbnail rasterize the same canvas
                        # independently (mesh bboxes vs volume/mosaic extent)
                        # and may disagree by a px of ceil; conform, padding
                        # as excluded
                        m = np.zeros(img.shape[:2], dtype=bool)
                        h = min(mask.shape[0], img.shape[0])
                        w = min(mask.shape[1], img.shape[1])
                        m[:h, :w] = mask[:h, :w]
                        mask = m
                kps = prepare_image(img, mask=mask,
                                    **dict(aconf.get('feature_matching', {}) or {}))
                cache[name] = (img, mask, kps)
                return cache[name]

            img0, mask0, kps0 = load(sec0)
            img1, mask1, kps1 = load(sec1)
            settings = {
                'match_mode': aconf.get('match_mode', 'feature'),
                'feature_matching': dict(aconf.get('feature_matching', {}) or {},
                                         kps0=kps0, kps1=kps1),
                'block_matching': aconf.get('block_matching', {}),
            }
            match, coarse = align_two_thumbnails(img0, img1, mask0=mask0,
                                                 mask1=mask1, return_coarse=True,
                                                 **settings)
            if match is None:
                logger.warning(f'{sec0} -> {sec1}: thumbnail matching failed')
                continue
            if aconf.get('save_feature_match', False) and coarse is not None:
                fdir = join_paths(work_dir, 'thumbnail_align', 'feature_matches')
                save_matches_to_h5(join_paths(fdir, match_name(
                    sec0, sec1, aconf.get('match_name_delimiter', '__to__'))),
                    coarse, res)
            save_matches_to_h5(out, match, res)
            logger.info(f'{sec0} -> {sec1}: {len(match.weight)} coarse matches '
                        f'in {timer.elapsed:.1f}s')


def optimize_main(args, conf, logger):
    """Rough alignment at thumbnail resolution: mesh each thumbnail, run
    the sliding-window relaxation, save thumbnail tforms."""
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.aligner import Aligner
    from feabas_tpu_torch.common import imread
    import cv2
    work_dir = config.get_work_dir()
    oconf = dict(conf.get('alignment', {}).get('optimization', {}) or {})
    thumb_mip = int(conf.get('thumbnail_mip_level', 6))
    res = config.montage_resolution() * (2 ** thumb_mip)
    fmt = conf.get('downsample', {}).get('thumbnail_format', 'png')
    mesh_dir = join_paths(work_dir, 'thumbnail_align', 'mesh')
    mask_dir = join_paths(work_dir, 'thumbnail_align', 'material_masks')
    names = [n for n, _ in stitched_sections(work_dir, None)]
    mconf = oconf.get('meshing_config', {}) or {}
    for name in names:
        out = join_paths(mesh_dir, name + '.h5')
        if storage.file_exists(out, use_cache=True):
            continue
        mask_file = join_paths(mask_dir, name + '.png')
        if storage.file_exists(mask_file):
            # mesh the section's material mask so excluded regions carry
            # no elements (reference meshes thumbnails from masks:
            # thumbnail_main.py:583-632)
            from feabas_tpu_torch.spatial import Geometry
            geom = Geometry.from_image(
                mask_file, scale=1.0, resolution=res,
                material_table=config.material_table())
            mesh = Mesh.from_geometry(
                geom, mesh_size=mconf.get('mesh_size', 100),
                simplify_tol=mconf.get('simplify_tol', 2),
                resolution=res, name=name)
        else:
            img = imread(thumb_path(work_dir, name, fmt),
                         flag=cv2.IMREAD_GRAYSCALE)
            mesh = Mesh.from_bbox((0, 0, img.shape[1], img.shape[0]),
                                  cartesian=True,
                                  mesh_size=mconf.get('mesh_size', 100),
                                  resolution=res, name=name)
        mesh.save_to_h5(out)
    al = Aligner(mesh_dir,
                 join_paths(work_dir, 'thumbnail_align', 'tform'),
                 join_paths(work_dir, 'thumbnail_align', 'matches'),
                 resolution=res, logger=logger)
    committed = al.run(chunk_settings=oconf.get('chunk_settings'),
                       slide_window=oconf.get('slide_window'))
    logger.info(f'thumbnail optimization: committed {len(committed)}')


def render_main(args, conf, logger):
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.dal import StreamLoader
    from feabas_tpu_torch.renderer import MeshRenderer
    from feabas_tpu_torch.common import imread, imwrite
    import cv2
    work_dir = config.get_work_dir()
    fmt = conf.get('downsample', {}).get('thumbnail_format', 'png')
    tform_dir = join_paths(work_dir, 'thumbnail_align', 'tform')
    out_dir = join_paths(work_dir, 'thumbnail_align', 'aligned')
    names = [n for n, _ in stitched_sections(work_dir, args)]
    tpaths = [join_paths(tform_dir, n + '.h5') for n in names]
    avail = [(n, t) for n, t in zip(names, tpaths)
             if storage.file_exists(t)]
    if not avail:
        return
    rconf = dict(conf.get('render', {}) or {})
    canvas = None
    if rconf.get('normalize', True):
        # one rigid normalization over the WHOLE stack: derotate (angle
        # null -> minimum-rectangle auto) + pin the bbox corner, then
        # render onto the normalized canvas (reference
        # normalize_transforms: thumbnail_main.py:295). angle=0 +
        # offset=(0,0) is idempotent across re-runs.
        from feabas_tpu_torch.aligner import normalize_transforms
        # reference key names (thumbnail_main.py:655-656): bbox_offset
        # (null -> no shift) and rotation_angle in degrees (absent/null ->
        # auto minimum-rectangle derotation)
        offset = rconf.get('bbox_offset', rconf.get('offset', (0.0, 0.0)))
        canvas = normalize_transforms(
            [t for _, t in avail], angle=rconf.get('rotation_angle', None),
            offset=None if offset is None else tuple(offset))
        storage.clear_exists_cache()
    meshes = {}
    boxes = []
    for name, t in avail:
        meshes[name] = Mesh.from_h5(t)
        boxes.append(meshes[name].bbox(gear='MOVING'))
    boxes = np.asarray(boxes)
    if canvas is None:
        canvas = (float(boxes[:, 0].min()), float(boxes[:, 1].min()),
                  float(boxes[:, 2].max()), float(boxes[:, 3].max()))
    for name, mesh in meshes.items():
        out = join_paths(out_dir, f'{name}.{fmt}')
        if storage.file_exists(out, use_cache=True):
            continue
        img = imread(thumb_path(work_dir, name, fmt), flag=cv2.IMREAD_GRAYSCALE)
        r = MeshRenderer.from_mesh(mesh, image_loader=StreamLoader(img))
        blk = r.crop(canvas)
        imwrite(out, blk)
        logger.info(f'{name}: aligned thumbnail rendered')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='thumbnail pipeline (PyTorch '
                                            'port)')
    modes = ['downsample', 'matching', 'optimization', 'render', 'alignment']
    p.add_argument('--mode', default='downsample', type=unique_prefix_arg(modes),
                   choices=modes)
    p.add_argument('--start', type=int, default=0)
    p.add_argument('--stop', type=int, default=None)
    p.add_argument('--step', type=int, default=1)
    p.add_argument('--reverse', action='store_true')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    # the CUDA card unless FEABAS_TORCH_DEVICE names another device: raises
    # here, before any work, when it is absent
    device_mod.get_device()
    conf = config.thumbnail_configs()
    info, logger = initialize_main_logger(prefix=f'thumb_{args.mode}',
                                          mp_queue=False)
    # 'alignment' chains the three z-alignment stages in one run
    # (reference: thumbnail_main.py:398,470-)
    stages = {'downsample': [downsample_main], 'matching': [matching_main],
              'optimization': [optimize_main], 'render': [render_main],
              'alignment': [matching_main, optimize_main, render_main]}
    with stage_timer(logger, f'thumbnail.{args.mode}'):
        for fn in stages[args.mode]:
            fn(args, conf, logger)
    terminate_logger(info, logger)


if __name__ == '__main__':
    main()
