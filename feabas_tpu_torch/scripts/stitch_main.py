"""Stitching CLI of the PyTorch port: matching -> optimization ->
rendering, with the flags and work-dir protocol of scripts/stitch_main.py.

    python -m feabas_tpu_torch.scripts.stitch_main --mode matching|optimization|rendering
                          [--filter F --start S --stop E --step K --reverse]

Coordinate files in ``stitch/stitch_coord/*.txt``; matches to
``stitch/match_h5/{sec}.h5``; transforms to ``stitch/tform/{sec}.h5``;
rendered tiles (or, with a volume ``rendering.driver``, one volume a
section) to ``stitched_sections/mip0/``. Existing outputs are skipped.
The compute device comes from FEABAS_TORCH_DEVICE (the CUDA card when
unset; set it to 'cpu' to run on the CPU).
"""

import argparse

import numpy as np

from feabas_tpu_torch import config, storage
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch.common import unique_prefix_arg
from feabas_tpu_torch.logging import (initialize_main_logger, stage_timer,
                                      terminate_logger)


def section_list(work_dir, slicing):
    coord_dir = storage.join_paths(work_dir, 'stitch', 'stitch_coord')
    files = storage.list_folder_content(storage.join_paths(coord_dir, '*.txt'))
    names = [storage.base_name(f).rsplit('.', 1)[0] for f in files]
    pairs = list(zip(names, files))
    filt = getattr(slicing, 'filter', '') or ''
    if filt:
        pairs = [pr for pr in pairs if filt in pr[0]]
    if slicing.reverse:
        pairs = pairs[::-1]
    return pairs[slice(slicing.start, slicing.stop, slicing.step)]


def match_main(sections, conf, logger):
    from feabas_tpu_torch.stitcher import Stitcher
    work_dir = config.get_work_dir()
    out_dir = storage.join_paths(work_dir, 'stitch', 'match_h5')
    for name, coord in sections:
        out = storage.join_paths(out_dir, name + '.h5')
        err_file = out + '_err'
        if storage.file_exists(out, use_cache=True):
            continue
        with stage_timer(None, 'stitch.matching.section') as timer:
            st = Stitcher.from_coordinate_file(coord, name=name)
            if storage.file_exists(err_file):
                # salvage partial matches of an interrupted run
                try:
                    prev = Stitcher.from_h5(err_file, load_meshes=False)
                    st.matches.update(prev.matches)
                    st.photometrics.update(prev.photometrics)
                    logger.info(f'{name}: resuming with {len(st.matches)} '
                                'salvaged matches')
                except (OSError, KeyError, ValueError) as e:
                    logger.warning(f'{name}: could not salvage {err_file}: {e}')
            try:
                n = st.dispatch_matchers(**conf.get('matching', {}))
            except Exception:
                if st.matches:
                    st.save_to_h5(err_file, save_meshes=False)
                    logger.warning(f'{name}: matching crashed; '
                                   f'{len(st.matches)} matches salvaged to _err')
                raise
            st.save_to_h5(out, save_meshes=False)
            storage.remove_file(err_file)
            logger.info(f'{name}: matched {n} overlaps in {timer.elapsed:.1f}s')


def optimize_main(sections, conf, logger):
    from feabas_tpu_torch.stitcher import Stitcher
    work_dir = config.get_work_dir()
    match_dir = storage.join_paths(work_dir, 'stitch', 'match_h5')
    tform_dir = storage.join_paths(work_dir, 'stitch', 'tform')
    opt = conf.get('optimization', {})
    for name, _ in sections:
        out = storage.join_paths(tform_dir, name + '.h5')
        src = storage.join_paths(match_dir, name + '.h5')
        if storage.file_exists(out, use_cache=True) or not storage.file_exists(src):
            continue
        with stage_timer(None, 'stitch.optimization.section') as timer:
            st = Stitcher.from_h5(src, load_meshes=False)
            if opt.get('equalize_brightness_contrast', False):
                st.equalize_brightness_contrast()
            if opt.get('msem', False) or opt.get('use_group', False):
                try:
                    st.set_groupings(msem=opt.get('msem', False))
                except (ValueError, IndexError):
                    pass  # paths don't follow MultiSEM conventions
            st.initialize_meshes(**(opt.get('mesh_settings') or {}))
            st.initialize_optimizer(minweight=opt.get('minweight', 0.1))
            if opt.get('msem', False) and st.groupings is not None:
                from feabas_tpu_torch.multisem import (
                    filter_links_from_sfov_pattern, mfovids_beamids_from_filenames)
                _, beams = mfovids_beamids_from_filenames(st.imgpaths)
                filter_links_from_sfov_pattern(st._slm, st.groupings, beams)
            st.optimize_translation(**(opt.get('translation') or {}))
            aff = opt.get('affine') or {}
            if aff.get('maxiter', 0) is None or aff.get('maxiter', 0) != 0:
                st.optimize_affine(**aff)
            if st.groupings is not None and (opt.get('group_elastic') or {}):
                st.optimize_group_intersection(**(opt.get('group_elastic') or {}))
            cost = st.optimize_elastic(**(opt.get('final_elastic') or {}))
            if not getattr(st, 'last_solve_converged', True):
                # never commit a diverged tform; leave an inspectable _err file
                st.save_to_h5(out + '_err', save_matches=False, save_meshes=True)
                logger.error(f'{name}: elastic solve diverged '
                             f'(cost {cost[0]:.2f}->{cost[1]:.2f}); tform NOT '
                             f'committed, wrote {out}_err')
                continue
            st.correct_invalid_meshes()
            st.connect_isolated_subsystem(**(opt.get('disconnected_assemble') or {}))
            st.normalize_coordinates(**(opt.get('normalize') or {}))
            r = st.match_residues()
            st.save_to_h5(out, save_matches=False, save_meshes=True)
            p90 = float(np.quantile(r, 0.9)) if r.size else 0.0
            logger.info(f'{name}: elastic cost {cost[0]:.2f}->{cost[1]:.2f}, '
                        f'residue p90 {p90:.2f}px in {timer.elapsed:.1f}s')


def render_main(sections, conf, logger):
    """Render each section to PNG tiles (driver ``image``) or into a
    chunked volume of its own (neuroglancer_precomputed, zarr, n5), with
    its ``metadata.txt`` or the volume's ``info`` as the done flag."""
    from feabas_tpu_torch.stitcher import MontageRenderer
    work_dir = config.get_work_dir()
    tform_dir = storage.join_paths(work_dir, 'stitch', 'tform')
    rconf = conf.get('rendering', {})
    driver = rconf.get('driver', 'image')
    out_root = rconf.get('out_dir') or storage.join_paths(work_dir, 'stitched_sections')
    out_root = storage.join_paths(out_root, 'mip0')
    fname_conf = rconf.get('filename_settings') or {}
    for name, _ in sections:
        src = storage.join_paths(tform_dir, name + '.h5')
        out_dir = storage.join_paths(out_root, name)
        done_flag = storage.join_paths(
            out_dir, 'metadata.txt' if driver == 'image' else 'info')
        if storage.file_exists(done_flag, use_cache=True) or not storage.file_exists(src):
            continue
        with stage_timer(None, 'stitch.rendering.section') as timer:
            mr = MontageRenderer.from_h5(
                src, loader_config=rconf.get('loader_settings') or {},
                **(rconf.get('render_settings') or {}))
            if driver == 'image':
                tiles = mr.render_series_to_file(
                    out_dir, tile_size=tuple(rconf.get('tile_size', (4096, 4096))),
                    pattern=fname_conf.get('pattern', '_tr{ROW_IND}-tc{COL_IND}.png'),
                    one_based=fname_conf.get('one_based', True),
                    num_workers=rconf.get('num_workers', 1))
                n_out = len(tiles)
            else:
                n_out = mr.render_series_to_tensorstore(
                    out_dir, driver=driver,
                    read_chunk_size=tuple(rconf.get('read_chunk_size', (256, 256))),
                    jpeg_compression=rconf.get('jpeg_compression', False),
                    pad_to_tile_size=rconf.get(
                        'pad_to_tile_size', rconf.get('jpeg_compression', False)))
            logger.info(f'{name}: rendered {n_out} tiles in '
                        f'{timer.elapsed:.1f}s')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='stitching pipeline (PyTorch port)')
    modes = ['matching', 'optimization', 'rendering']
    p.add_argument('--mode', default='matching', type=unique_prefix_arg(modes),
                   choices=modes)
    p.add_argument('--filter', type=str, default='',
                   help='only process sections whose name contains this substring')
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
    conf = config.stitch_configs()
    mode_conf = conf.get(args.mode, {})
    config.set_numpy_thread_from_num_workers(mode_conf.get('num_workers', 1) or 1)
    info, logger = initialize_main_logger(prefix=f'stitch_{args.mode}', mp_queue=False)
    sections = section_list(config.get_work_dir(), args)
    logger.info(f'stitch {args.mode}: {len(sections)} section(s)')
    with stage_timer(None, f'stitch.{args.mode}'):
        {'matching': match_main, 'optimization': optimize_main,
         'rendering': render_main}[args.mode](sections, conf, logger)
    terminate_logger(info, logger)


if __name__ == '__main__':
    main()
