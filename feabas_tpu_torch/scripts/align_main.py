"""Alignment CLI of the PyTorch port: meshing -> matching -> optimization ->
rendering -> downsample (or tsr -> tsd), with the flags and work-dir
protocol of scripts/align_main.py.

    python -m feabas_tpu_torch.scripts.align_main --mode meshing|matching|optimization|rendering|downsample|tsr|tsd
                          [--filter F --slurm_config Y --start S --stop E --step K --reverse]

Stitched sections under ``stitched_sections/mip0/{sec}`` (metadata.txt
coordinate files); meshes to ``align/mesh``, matches to ``align/matches``,
transforms to ``align/tform``, rendered sections to
``aligned_stack/mip{k}``. Coarse seeds come from
``thumbnail_align/matches`` when present, else neighbouring sections are
seeded by whole-image translation. ``section_order.txt`` in the work dir
reorders sections. The compute device comes from FEABAS_TORCH_DEVICE
(the CUDA card when unset; 'cpu' runs on the CPU). ``tsr`` renders the
aligned stack into one chunked volume (``aligned_tensorstore``) and
``tsd`` adds its lower-resolution scales.
"""

import argparse

import numpy as np

from feabas_tpu_torch import config, storage, trace
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch.common import unique_prefix_arg
from feabas_tpu_torch.logging import (initialize_main_logger, stage_timer,
                                      terminate_logger)
from feabas_tpu_torch.storage import join_paths


def stitched_section_list(work_dir, slicing=None):
    """[(name, source)] of the stitched sections: metadata.txt mosaics and
    tensorstore-rendered section dirs."""
    from feabas_tpu_torch.mipmap import tensorstore_spec_for_dir
    root = join_paths(work_dir, 'stitched_sections', 'mip0')
    metas = storage.list_folder_content(join_paths(root, '*', 'metadata.txt'))
    pairs = [(m.rstrip('/').split('/')[-2], m) for m in sorted(metas)]
    seen = {n for n, _ in pairs}
    for d in sorted(storage.list_folder_content(join_paths(root, '*/'))):
        name = d.rstrip('/').split('/')[-1]
        if name not in seen and tensorstore_spec_for_dir(d) is not None:
            pairs.append((name, d.rstrip('/')))
    pairs.sort()
    if slicing is not None:
        if slicing.reverse:
            pairs = pairs[::-1]
        pairs = pairs[slice(slicing.start, slicing.stop, slicing.step)]
    return pairs


def section_loader(meta, **loader_config):
    """Loader of a stitched section: a coordinate-file mosaic for
    ``metadata.txt``, a TensorStoreLoader for a rendered-volume dir."""
    from feabas_tpu_torch.dal import StaticImageLoader, TensorStoreLoader
    if str(meta).endswith('.txt'):
        return StaticImageLoader.from_coordinate_file(meta, **loader_config)
    from feabas_tpu_torch.mipmap import tensorstore_spec_for_dir
    spec = tensorstore_spec_for_dir(meta)
    if spec is None:
        raise RuntimeError(f'not a stitched section source: {meta}')
    return TensorStoreLoader(spec, **loader_config)


def section_source_bbox(loader):
    """World bbox of a section source (mosaic tile union or TS domain)."""
    if hasattr(loader, 'bboxes'):
        b = np.asarray(loader.bboxes)
        return (b[:, 0].min(), b[:, 1].min(), b[:, 2].max(), b[:, 3].max())
    dom = loader.dataset.domain
    return (int(dom[0].inclusive_min), int(dom[1].inclusive_min),
            int(dom[0].exclusive_max), int(dom[1].exclusive_max))


def meshing_main(args, conf, logger):
    """Per-section mesh from its material mask (or the section bbox when
    there is none), carried through the thumbnail transform when one
    exists."""
    from feabas_tpu_torch.mesh import Mesh, transform_mesh
    from feabas_tpu_torch.spatial import Geometry
    from feabas_tpu_torch.optimizer import relax_mesh_most_deformed
    work_dir = config.get_work_dir()
    mconf = conf.get('meshing', {})
    mesh_size = mconf.get('mesh_size', 600)
    mask_dir = mconf.get('mask_dir') or join_paths(work_dir, 'align',
                                                   'material_masks')
    mask_mip = int(mconf.get('mask_mip_level', 4))
    out_dir = join_paths(work_dir, 'align', 'mesh')
    res = config.montage_resolution()
    for name, meta in stitched_section_list(work_dir, args):
        out = join_paths(out_dir, name + '.h5')
        if storage.file_exists(out, use_cache=True):
            continue
        mask_file = join_paths(mask_dir, name + '.png')
        if storage.file_exists(mask_file):
            geom = Geometry.from_image(mask_file, scale=2 ** mask_mip,
                                       material_table=config.material_table())
            mesh = Mesh.from_geometry(
                geom, mesh_size=mesh_size,
                simplify_tol=mconf.get('simplify_tol', 2),
                area_thresh=mconf.get('area_thresh', 25),
                min_mesh_angle=mconf.get('min_mesh_angle', 0),
                resolution=res, name=name)
        else:
            bbox = section_source_bbox(section_loader(meta))
            mesh = Mesh.from_bbox(bbox, cartesian=False, mesh_size=mesh_size,
                                  resolution=res, name=name)
        thumb_tform = join_paths(work_dir, 'thumbnail_align', 'tform',
                                 name + '.h5')
        if storage.file_exists(thumb_tform):
            carrier = Mesh.from_h5(thumb_tform)
            carrier.change_resolution(res)
            mesh = transform_mesh(mesh, carrier)
            relax_mesh_most_deformed(mesh)
        mesh.save_to_h5(out)
        logger.info(f'{name}: mesh {mesh.num_vertices}v/{mesh.num_triangles}t')


_MATCHER_KEYS = ('spacings', 'sigma', 'conf_thresh', 'pad', 'residue_mode',
                 'residue_len', 'batch_size', 'shrink_factor',
                 'min_boundary_distance', 'distributor', 'geodesic_mask',
                 'allow_dwell', 'max_spacing_skip',
                 'min_block_size_multiplier', 'link_weight_decay',
                 'split_disconnected', 'render_weight_threshold',
                 'stiffness_multiplier_threshold')


def matching_main(args, conf, logger):
    """Fine matching between neighbouring sections (and every pair with a
    thumbnail match) at the working mip level."""
    from feabas_tpu_torch import constant as const
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.aligner import (match_name, parse_match_name,
                                          read_matches_from_h5,
                                          save_matches_to_h5)
    from feabas_tpu_torch.matcher import (global_translation_matcher,
                                          section_matcher)
    from feabas_tpu_torch.optimizer import SLM
    work_dir = config.get_work_dir()
    mconf = dict(conf.get('matching', {}))
    matcher_config = dict(mconf.get('matcher_config', {}) or {})
    compare_distance = int(mconf.pop('compare_distance', 1) or 1)
    out_dir = join_paths(work_dir, 'align', 'matches')
    mesh_dir = join_paths(work_dir, 'align', 'mesh')
    thumb_match_dir = join_paths(work_dir, 'thumbnail_align', 'matches')
    sections, _ = _apply_section_order(
        work_dir, stitched_section_list(work_dir, None))
    names = [n for n, _ in sections]
    metas = dict(sections)
    res = config.align_resolution()
    # one working px spans mip_scale mip0 px
    mip_scale = res / config.montage_resolution()
    matcher_config.setdefault('spacings', [400, 100])
    matcher_config['spacings'] = (
        np.asarray(matcher_config['spacings'], np.float64) / mip_scale)
    rlen = matcher_config.get('residue_len', -2)
    if rlen is not None and rlen < 0:
        matcher_config['residue_len'] = abs(rlen) * config.section_thickness() / res
    pairs = []
    for d in range(1, compare_distance + 1):
        pairs += [(names[i], names[i + d]) for i in range(len(names) - d)]
    # every thumbnail match defines a fine-matching pair too (long-range
    # anchors that bound the drift random walk)
    if mconf.get('include_thumbnail_pairs', True):
        known = set(names)
        have = set(pairs) | {(b, a) for a, b in pairs}
        extra = []
        for f in storage.list_folder_content(
                join_paths(thumb_match_dir, '*.h5')):
            a, b = parse_match_name(f)
            if a in known and b in known and (a, b) not in have:
                extra.append((a, b))
                have.update(((a, b), (b, a)))
        if extra:
            logger.info(f'matching: +{len(extra)} pair(s) from thumbnail '
                        'matches beyond compare_distance')
            pairs += extra
    if args.reverse:
        pairs = pairs[::-1]
    pairs = pairs[slice(args.start, args.stop, args.step)]
    loader_config = mconf.get('loader_config') or {}
    max_px = float(mconf.get('max_device_pixels', 4e8))
    for sec0, sec1 in pairs:
        out = join_paths(out_dir, match_name(sec0, sec1))
        if storage.file_exists(out, use_cache=True):
            continue
        with stage_timer(None, 'align.matching.pair') as timer:
            mesh0 = Mesh.from_h5(join_paths(mesh_dir, sec0 + '.h5'))
            mesh1 = Mesh.from_h5(join_paths(mesh_dir, sec1 + '.h5'))
            mesh0.change_resolution(res)
            mesh1.change_resolution(res)
            mesh0.uid, mesh1.uid = 0.0, 1.0
            mesh0.locked = True
            loader0 = section_loader(metas[sec0], **loader_config)
            loader1 = section_loader(metas[sec1], **loader_config)
            if mip_scale != 1.0:
                loader0 = _ScaledLoader(loader0, mip_scale)
                loader1 = _ScaledLoader(loader1, mip_scale)
            # a section that fits in memory at working resolution is cropped
            # once and its blocks are warped on the device
            loader0 = _maybe_stream(loader0, mesh0, max_px)
            loader1 = _maybe_stream(loader1, mesh1, max_px)
            thumb_match = join_paths(thumb_match_dir, match_name(sec0, sec1))
            if storage.file_exists(thumb_match):
                coarse = read_matches_from_h5(thumb_match,
                                              target_resolution=res)
                slm = SLM([mesh0, mesh1])
                slm.add_link_from_coordinates(0.0, 1.0, coarse.xy0, coarse.xy1,
                                              weight=coarse.weight)
                slm.optimize_affine_cascade(start_gear=const.MESH_GEAR_INITIAL)
            else:
                # translation seed from the whole-section overlap
                bb0 = mesh0.bbox(gear=const.MESH_GEAR_INITIAL)
                bb1 = mesh1.bbox(gear=const.MESH_GEAR_INITIAL)
                with trace.span('matcher.seed'):
                    dx, dy, _ = global_translation_matcher(
                        loader0.crop(bb0).astype(np.float32),
                        loader1.crop(bb1).astype(np.float32),
                        sigma=matcher_config.get('sigma', 3.5))
                c0 = np.array([(bb0[0] + bb0[2]) / 2, (bb0[1] + bb0[3]) / 2])
                c1 = np.array([(bb1[0] + bb1[2]) / 2, (bb1[1] + bb1[3]) / 2])
                mesh1.set_translation(c0 - c1 - np.array([dx, dy]))
            match = section_matcher(
                mesh0, mesh1, loader0, loader1,
                **{k: v for k, v in matcher_config.items()
                   if k in _MATCHER_KEYS})
            if match is None:
                logger.warning(f'{sec0} -> {sec1}: matching failed')
                continue
            save_matches_to_h5(out, match, res)
            logger.info(f'{sec0} -> {sec1}: {len(match.weight)} matches '
                        f'in {timer.elapsed:.1f}s')


def _maybe_stream(loader, mesh, max_px, margin=64):
    """Crop a section's mesh extent into memory when it fits, so its
    blocks render on the device."""
    from feabas_tpu_torch.dal import StreamLoader
    bb = mesh.bbox(gear='INITIAL')
    w = bb[2] - bb[0] + 2 * margin
    h = bb[3] - bb[1] + 2 * margin
    if w * h > max_px:
        return loader
    x0 = int(np.floor(bb[0] - margin))
    y0 = int(np.floor(bb[1] - margin))
    img = loader.crop((x0, y0, x0 + int(np.ceil(w)), y0 + int(np.ceil(h))))
    return StreamLoader(img, offset=(x0, y0))


class _ScaledLoader:
    """Serve crops at a coarser working resolution by area-downscaling a
    mip0 loader's crops."""

    def __init__(self, loader, scale):
        self._loader = loader
        self._scale = float(scale)  # working px -> mip0 px
        self.default_fillval = loader.default_fillval
        self.dtype = loader.dtype
        self.number_of_channels = loader.number_of_channels

    def crop(self, bbox, return_empty=False, **kwargs):
        import cv2
        b0 = [v * self._scale for v in bbox]
        img = self._loader.crop(b0, return_empty=return_empty, **kwargs)
        if img is None:
            return None
        h = int(round(bbox[3] - bbox[1]))
        w = int(round(bbox[2] - bbox[0]))
        with trace.span('loader.resize'):
            return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)


def _apply_section_order(work_dir, sections):
    """Reorder/filter sections by ``<work_dir>/section_order.txt`` (lines
    are names, or ``z<TAB>name``). Returns (ordered sections, {name: z})."""
    from feabas_tpu_torch.common import rearrange_section_order
    onames, zidx = rearrange_section_order(
        [n for n, _ in sections], join_paths(work_dir, 'section_order.txt'))
    metas = dict(sections)
    return ([(n, metas[n]) for n in onames],
            {n: int(z) for n, z in zip(onames, zidx)})


def downsample_main(args, conf, logger):
    """Mip pyramids of the rendered aligned stack (host). With
    ``parallel_within_section`` the section loop stays serial and each
    section uses the workers; otherwise whole sections fan out."""
    from feabas_tpu_torch.concurrent import submit_to_workers
    from feabas_tpu_torch.mipmap import mip_map_one_section
    work_dir = config.get_work_dir()
    dconf = dict(conf.get('downsample', {}) or {})
    out_root = (conf.get('rendering', {}) or {}).get('out_dir') \
        or join_paths(work_dir, 'aligned_stack')
    max_mip = int(dconf.get('max_mip', 8))
    fmt = dconf.get('format', 'jpg')
    num_workers = int(dconf.get('num_workers', 1) or 1)
    within = bool(dconf.get('parallel_within_section', True))
    metas = sorted(storage.list_folder_content(
        join_paths(out_root, 'mip0', '*', 'metadata.txt')))
    pairs = [(m.rstrip('/').split('/')[-2], m) for m in metas]
    if getattr(args, 'filter', None):
        pairs = [p for p in pairs if args.filter in p[0]]
    if args.reverse:
        pairs = pairs[::-1]
    pairs = pairs[slice(args.start, args.stop, args.step)]
    loader_cfg = dict(dconf.get('loader_config') or {})
    if within or num_workers <= 1:
        for name, meta in pairs:
            with stage_timer(None, 'align.downsample.section') as timer:
                mip_map_one_section(name, meta, out_root, max_mip=max_mip,
                                    fmt=fmt, num_workers=num_workers,
                                    **loader_cfg)
                logger.info(f'{name}: mipmapped in {timer.elapsed:.1f}s')
    else:
        jobs = [(n, m, out_root) for n, m in pairs]
        list(submit_to_workers(
            mip_map_one_section, jobs,
            kwargs_list=[dict(max_mip=max_mip, fmt=fmt, **loader_cfg)
                         for _ in jobs],
            num_workers=num_workers))
        logger.info(f'downsample: mipmapped {len(jobs)} section(s)')


def get_or_make_canvas(tform_dir, logger=None):
    """Shared render canvas, persisted to ``<tform_dir>/canvas.json``:
    computed once from every tform present and reused by later (filtered
    or sliced) runs, which all render on one grid. A tform committed after
    the canvas that falls outside it is warned about, not clipped
    silently."""
    import json
    from feabas_tpu_torch.common import get_canvas_bbox
    from feabas_tpu_torch.mesh import Mesh
    cf = join_paths(tform_dir, 'canvas.json')
    tforms = sorted(storage.list_folder_content(join_paths(tform_dir, '*.h5')))
    if storage.file_exists(cf):
        with storage.File(cf, 'r') as f:
            saved = json.load(f)
        bbox = get_canvas_bbox(saved, target_mip=0)
        new = [t for t in tforms
               if storage.base_name(t) not in set(saved.get('sections', []))]
        if new and bbox is not None and logger is not None:
            for t in new:
                b = Mesh.from_h5(t).bbox(gear='MOVING')
                if (b[0] < bbox[0] or b[1] < bbox[1]
                        or b[2] > bbox[2] or b[3] > bbox[3]):
                    logger.warning(
                        f'{storage.base_name(t)} extends beyond the saved '
                        f'render canvas {bbox} ({cf} was written before '
                        f'this tform existed) and will be clipped; delete '
                        f'{cf} and re-render to regrow the canvas')
        return bbox
    if not tforms:
        return None
    boxes = np.asarray([Mesh.from_h5(t).bbox(gear='MOVING') for t in tforms])
    bbox = [int(np.floor(boxes[:, 0].min())), int(np.floor(boxes[:, 1].min())),
            int(np.ceil(boxes[:, 2].max())) + 1,
            int(np.ceil(boxes[:, 3].max())) + 1]
    with storage.File(cf, 'w') as f:
        json.dump({'mip0': bbox,
                   'sections': [storage.base_name(t) for t in tforms]}, f)
    if logger is not None:
        logger.info(f'canvas bbox {bbox} -> {cf}')
    return bbox


def optimize_main(args, conf, logger):
    from feabas_tpu_torch.aligner import Aligner
    work_dir = config.get_work_dir()
    oconf = dict(conf.get('optimization', {}))
    if getattr(args, 'slurm_config', None):
        # hand whole optimization windows to sbatch workers configured by
        # the given YAML
        if not storage.file_exists(args.slurm_config):
            raise FileNotFoundError(args.slurm_config)
        scfg = storage.load_yaml(args.slurm_config)
        slide = dict(oconf.get('slide_window') or {})
        slide['parallel_framework'] = 'slurm'
        ds = dict(slide.get('dispatch_settings') or {})
        ds.update(scfg or {})
        slide['dispatch_settings'] = ds
        oconf['slide_window'] = slide
    stack_conf = oconf.get('stack_config') or {}
    mip = int(stack_conf.get('mip_level', 0) or 0)
    al = Aligner(join_paths(work_dir, 'align', 'mesh'),
                 join_paths(work_dir, 'align', 'tform'),
                 join_paths(work_dir, 'align', 'matches'),
                 resolution=config.montage_resolution() * (2 ** mip),
                 section_order_file=join_paths(work_dir, 'section_order.txt'),
                 logger=logger)
    committed = al.run(chunk_settings=oconf.get('chunk_settings'),
                       slide_window=oconf.get('slide_window'),
                       num_workers=oconf.get('num_workers', 1))
    logger.info(f'optimization: committed {len(committed)} section(s)')
    al.write_residue_file(join_paths(work_dir, 'align', 'residues.csv'))


def render_main(args, conf, logger):
    from feabas_tpu_torch.common import interp_from_name
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.renderer import render_whole_mesh
    work_dir = config.get_work_dir()
    rconf = conf.get('rendering', {})
    out_root = rconf.get('out_dir') or join_paths(work_dir, 'aligned_stack')
    out_root = join_paths(out_root, 'mip0')
    tform_dir = join_paths(work_dir, 'align', 'tform')
    sections, zmap = _apply_section_order(
        work_dir, stitched_section_list(work_dir, None))
    if getattr(args, 'filter', None):
        sections = [s for s in sections if args.filter in s[0]]
    if args.reverse:
        sections = sections[::-1]
    sections = sections[slice(args.start, args.stop, args.step)]
    # one shared canvas for every section, persisted for later runs
    canvas = rconf.get('canvas_bbox', None)
    if canvas is None and rconf.get('offset_bbox', True):
        canvas = get_or_make_canvas(tform_dir, logger)
    z_base = int(rconf.get('z_min', 0) or 0)
    for name, meta in sections:
        z = zmap[name] + z_base
        t = join_paths(tform_dir, name + '.h5')
        if not storage.file_exists(t):
            continue
        prefix_name = f'{z:05d}_{name}' \
            if rconf.get('prefix_z_number', True) else name
        out_dir = join_paths(out_root, prefix_name)
        if storage.file_exists(join_paths(out_dir, 'metadata.txt'),
                               use_cache=True):
            continue
        with stage_timer(None, 'align.rendering.section') as timer:
            loader = section_loader(meta, **(rconf.get('loader_config') or {}))
            # render->mip fusion: emit_mips = K also writes mip1..K tile dirs
            emit_mips = int(rconf.get('emit_mips', 0) or 0)
            mip_dirs = [join_paths(str(out_root).replace('mip0', f'mip{l}'),
                                   prefix_name)
                        for l in range(1, emit_mips + 1)]
            tiles = render_whole_mesh(
                Mesh.from_h5(t), loader, join_paths(out_dir, prefix_name),
                interpolation=interp_from_name(rconf.get('remap_interp')),
                tile_size=tuple(rconf.get('tile_size', (4096, 4096))),
                pattern=rconf.get('pattern', '_tr{ROW_IND}-tc{COL_IND}.png'),
                one_based=rconf.get('one_based', True),
                num_workers=int(rconf.get('num_workers', 1) or 1),
                device_render=rconf.get('device_render', None),
                mip_dirs=mip_dirs, canvas_bbox=canvas)
            with storage.File(join_paths(out_dir, 'metadata.txt'), 'w') as f:
                f.write('{ROOT_DIR}\t' + str(out_dir) + '\n')
                for fname, bbox in tiles.items():
                    f.write(f'{storage.base_name(fname)}\t{bbox[0]}\t{bbox[1]}'
                            f'\t{bbox[2]}\t{bbox[3]}\n')
            logger.info(f'{name}: rendered {len(tiles)} tiles in '
                        f'{timer.elapsed:.1f}s')


def tsr_main(args, conf, logger):
    """Render the aligned stack into a chunked volume (reference:
    align_main.py:477); with ``--filter`` an isolated sub-volume of the
    matching sections under ``<out_dir>/<filter>``, z renumbered from 0.
    ``--start/--stop/--step`` render part of the stack into the volume of
    the whole: the chunk layers of the other sections stay as stored."""
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.dal import TensorStoreWriter
    from feabas_tpu_torch.renderer import VolumeRenderer
    work_dir = config.get_work_dir()
    tconf = conf.get('tensorstore_rendering', {}) or {}
    out_dir = tconf.get('out_dir') or join_paths(work_dir, 'aligned_tensorstore')
    tform_dir = join_paths(work_dir, 'align', 'tform')
    sections, zmap = _apply_section_order(
        work_dir, stitched_section_list(work_dir, None))
    if getattr(args, 'filter', None):
        sections = [s for s in sections if args.filter in s[0]]
        if sections:
            zlo = min(zmap[n] for n, _ in sections)
            zmap = {n: zmap[n] - zlo for n, _ in sections}
        out_dir = join_paths(out_dir, args.filter)
    tform_list = []
    boxes = []
    metas = {}
    for name, meta in sections:
        t = join_paths(tform_dir, name + '.h5')
        if not storage.file_exists(t):
            continue
        mesh = Mesh.from_h5(t)
        boxes.append(mesh.bbox(gear='MOVING'))
        tform_list.append((zmap[name], name, mesh))
        metas[name] = meta
    if not tform_list:
        logger.warning('tsr: no aligned sections found')
        return
    z_lo = args.start or 0
    z_hi = args.stop if args.stop is not None else len(tform_list)
    canvas = tconf.get('canvas_bbox', None)
    if canvas is None:
        canvas = get_or_make_canvas(tform_dir, logger)
    if canvas is None:
        boxes = np.asarray(boxes)
        canvas = [int(np.floor(boxes[:, 0].min())),
                  int(np.floor(boxes[:, 1].min())),
                  int(np.ceil(boxes[:, 2].max())),
                  int(np.ceil(boxes[:, 3].max()))]
    z_max = tconf.get('z_max') or (max(z for z, _, _ in tform_list) + 1)
    writer = TensorStoreWriter.create(
        out_dir, canvas, z_max,
        driver=tconf.get('driver', 'neuroglancer_precomputed'),
        chunk_shape=tconf.get('chunk_shape', [2048, 2048, 16]),
        read_chunk_shape=tconf.get('read_chunk_shape'),
        resolution=config.montage_resolution(),
        thickness=config.section_thickness(),
        jpeg_compression=tconf.get('jpeg_compression', False))
    chosen = tform_list[z_lo:z_hi:args.step]
    loader_config = tconf.get('loader_config') or {}
    loaders = {name: section_loader(metas[name], **loader_config)
               for _, name, _ in chosen}
    vr = VolumeRenderer(chosen, loaders, writer,
                        flag_dir=join_paths(out_dir, 'render_flags'),
                        logger=logger,
                        remap_interp=tconf.get('remap_interp', 'LINEAR'),
                        device_render=tconf.get('device_render', None))
    n = vr.render_volume(num_workers=tconf.get('num_workers', 1),
                         chunks_per_job=tconf.get(
                             'chunks_per_job',
                             tconf.get('max_tile_per_job') or 16))
    logger.info(f'tsr: wrote {n} chunks to {out_dir}')


def tsd_main(args, conf, logger):
    """Downsample the rendered volume to lower mips (reference:
    align_main.py:519), into the volume's own directory unless
    ``tensorstore_downsample.out_dir`` names another."""
    from feabas_tpu_torch.mipmap import mip_one_level_tensorstore_3d
    work_dir = config.get_work_dir()
    tconf = conf.get('tensorstore_downsample', {}) or {}
    src_dir = conf.get('tensorstore_rendering', {}).get('out_dir') \
        or join_paths(work_dir, 'aligned_tensorstore')
    out_dir = tconf.get('out_dir')
    if getattr(args, 'filter', None):
        # the filtered sub-volume lives under <dir>/<filter>; an explicit
        # out_dir is isolated the same way so its scales never land in
        # the full volume's multiscale metadata
        src_dir = join_paths(src_dir, args.filter)
        if out_dir:
            out_dir = join_paths(out_dir, args.filter)
    out_dir = out_dir or src_dir
    n = mip_one_level_tensorstore_3d(
        src_dir, out_dir, mip_levels=tconf.get('mip_levels', [1, 3, 5, 7]),
        downsample_z=tconf.get('downsample_z', 'auto'),
        z_range=tconf.get('z_range'), logger=logger,
        keep_chunk_layout=tconf.get('keep_chunk_layout', True),
        cache_capacity=tconf.get('cache_capacity'),
        jpeg_compression=tconf.get('jpeg_compression'))
    logger.info(f'tsd: generated {n} mip level(s)')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='alignment pipeline (PyTorch '
                                            'port)')
    modes = ['meshing', 'matching', 'optimization', 'rendering',
             'downsample', 'tsr', 'tsd']
    p.add_argument('--mode', default='matching', type=unique_prefix_arg(modes),
                   choices=modes)
    p.add_argument('--filter', type=str, default=None,
                   help='render/downsample only sections whose name '
                        'contains this substring; tsr/tsd outputs go to an '
                        'isolated <out_dir>/<filter> sub-volume with z '
                        'renumbered from 0')
    p.add_argument('--slurm_config', type=str, default=None,
                   help='YAML with slurm dispatch settings; optimization '
                        'windows are then handed to sbatch workers')
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
    conf = config.align_configs()
    info, logger = initialize_main_logger(prefix=f'align_{args.mode}',
                                          mp_queue=False)
    with stage_timer(logger, f'align.{args.mode}'):
        {'meshing': meshing_main, 'matching': matching_main,
         'optimization': optimize_main, 'rendering': render_main,
         'downsample': downsample_main,
         'tsr': tsr_main, 'tsd': tsd_main}[args.mode](args, conf, logger)
    terminate_logger(info, logger)


if __name__ == '__main__':
    main()
