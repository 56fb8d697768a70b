"""The stitch slice through the port's CLI, against the JAX
package's CLI on a copy of the same work dir, and alone in a fresh
interpreter (no jax, no h5py)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from synthutil import tile_grid

# the tier-1 run shares the cores among several pytest workers: one torch
# thread per worker avoids oversubscription
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')


def _make_workdir(root, tiles, stage_bboxes, general_extra=None):
    """A config dir + work dir with one section; returns the config dir."""
    from feabas_tpu import storage
    from feabas_tpu.common import imwrite
    cfg = os.path.join(root, 'configs')
    shutil.copytree(os.path.join(REPO, 'configs'), cfg)
    wd = os.path.join(root, 'work_dir')
    storage.save_yaml(os.path.join(cfg, 'general_configs.yaml'), {
        'working_directory': wd, 'parallel_framework': 'serial',
        'full_resolution': 4, 'section_thickness': 30,
        'logfile_level': 'NONE', 'archive_level': 'NONE',
        'console_level': 'WARNING', 'cpu_budget': 2, **(general_extra or {})})
    tdir = os.path.join(wd, 'raw', 's0001')
    lines = ['{ROOT_DIR}\t' + tdir, '{RESOLUTION}\t4']
    for k, (tile, sb) in enumerate(zip(tiles, stage_bboxes)):
        fn = f'tile_{k:03d}.png'
        imwrite(os.path.join(tdir, fn), tile)
        lines.append(f'{fn}\t{sb[0]:.0f}\t{sb[1]:.0f}\t{sb[2]:.0f}\t{sb[3]:.0f}')
    with storage.File(os.path.join(wd, 'stitch', 'stitch_coord', 's0001.txt'),
                      'w') as f:
        f.write('\n'.join(lines) + '\n')
    # tiles here are small next to real EM tiles: no 2x coarse downsample
    storage.save_yaml(os.path.join(wd, 'configs', 'stitching_configs.yaml'), {
        'matching': {'matcher_config': {'coarse_downsample': 1.0,
                                        'conf_thresh': 0.25}},
        'rendering': {'loader_settings': {'apply_CLAHE': False,
                                          'inverse': False}}})
    return cfg, wd


def _run_cli(main, cfg, monkeypatch):
    from feabas_tpu import config
    from feabas_tpu_torch import config as pconfig
    monkeypatch.setenv('FEABAS_TPU_CONFIG_DIR', cfg)
    config.clear_config_caches()
    pconfig.clear_config_caches()
    try:
        for mode in ('matching', 'optimization', 'rendering'):
            main(['--mode', mode])
    finally:
        config.clear_config_caches()
        pconfig.clear_config_caches()


def _results(wd, true_bboxes):
    from feabas_tpu.dal import StaticImageLoader
    from feabas_tpu.stitcher import Stitcher
    st = Stitcher.from_h5(os.path.join(wd, 'stitch', 'match_h5', 's0001.h5'))
    tf = Stitcher.from_h5(os.path.join(wd, 'stitch', 'tform', 's0001.h5'))
    origins = np.asarray([m.vertices_w_offset('MOVING').mean(axis=0)
                          - m.vertices_w_offset('INITIAL').mean(axis=0)
                          for m in tf.meshes])
    canvas = StaticImageLoader.from_coordinate_file(os.path.join(
        wd, 'stitched_sections', 'mip0', 's0001', 'metadata.txt')).crop(
        (0, 0, int(true_bboxes[:, 2].max()), int(true_bboxes[:, 3].max())))
    return st, origins - origins[0], canvas


def _render_cc(canvas, world):
    import cv2
    H, W = world.shape
    patch = world[H // 4:3 * H // 4, W // 4:3 * W // 4].astype(np.float32)
    res = cv2.matchTemplate(canvas.astype(np.float32), patch,
                            cv2.TM_CCOEFF_NORMED)
    return float(res.max())


def test_port_stitch_matches_jax(tmp_path, monkeypatch):
    """2x3 grid with overlaps >= 256 px (the fused match path) and device
    rendering (the port's montage blend), port and JAX package on copies
    of one work dir."""
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    import stitch_main as jax_main
    from feabas_tpu_torch.scripts import stitch_main as port_main
    rng = np.random.default_rng(42)
    world, tiles, true_bb, stage_bb = tile_grid(
        rng, rows=2, cols=3, tile_h=300, tile_w=560, overlap=270, jitter=3.0)
    render = {'device': {'render': True}}
    cfg_j, wd_j = _make_workdir(str(tmp_path / 'jax'), tiles, stage_bb, render)
    cfg_p, wd_p = _make_workdir(str(tmp_path / 'port'), tiles, stage_bb, render)
    _run_cli(jax_main.main, cfg_j, monkeypatch)
    _run_cli(port_main.main, cfg_p, monkeypatch)
    st_j, place_j, _ = _results(wd_j, true_bb)
    st_p, place_p, canvas = _results(wd_p, true_bb)

    # every overlap of the grid is matched: the 7 neighbours and the 4
    # diagonals (their corner overlaps are >= 256 px too)
    assert len(st_p.matches) == 11 and sorted(st_p.matches) == sorted(st_j.matches)
    for key, m in st_p.matches.items():
        i, j = key
        err = (m.xy0 + true_bb[i][:2]) - (m.xy1 + true_bb[j][:2])
        assert (np.median(np.abs(err), axis=0) < 0.5).all(), key
        # against the JAX package (f64 here, f32 in the port)
        mj = st_j.matches[key]
        d_p = np.median(m.xy0 - m.xy1, axis=0)
        d_j = np.median(mj.xy0 - mj.xy1, axis=0)
        assert np.abs(d_p - d_j).max() < 0.1, (key, d_p, d_j)
    truth = true_bb[:, :2] - true_bb[0, :2]
    assert np.abs(place_p - truth).max() < 0.5
    assert np.abs(place_p - place_j).max() < 0.1
    assert _render_cc(canvas, world) > 0.9


_SUBPROCESS = r'''
import json, os, sys
sys.modules['h5py'] = None          # a host without h5py
from feabas_tpu_torch import storage
from feabas_tpu_torch.scripts import stitch_main
for mode in ('matching', 'optimization', 'rendering'):
    stitch_main.main(['--mode', mode])
print(json.dumps({'jax': sorted(m for m in sys.modules
                                if m == 'jax' or m.startswith('jax.')),
                  'feabas_tpu': sorted(m for m in sys.modules
                                       if m == 'feabas_tpu'
                                       or m.startswith('feabas_tpu.')),
                  'h5': storage.h5py.__name__}))
'''


def test_port_stitch_alone_imports_no_jax(tmp_path):
    """A fresh interpreter runs the port's CLI end to end (classic
    match path, host render) without importing jax or the JAX package, and
    on a host without h5py writes H5 files that h5py reads."""
    rng = np.random.default_rng(5)
    world, tiles, true_bb, stage_bb = tile_grid(
        rng, rows=2, cols=3, tile_h=160, tile_w=200, overlap=40, jitter=3.0)
    cfg, wd = _make_workdir(str(tmp_path), tiles, stage_bb)
    env = dict(os.environ, FEABAS_TPU_CONFIG_DIR=cfg, FEABAS_TORCH_DEVICE='cpu',
               PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    proc = subprocess.run([sys.executable, '-c', _SUBPROCESS], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {'jax': [], 'feabas_tpu': [],
                   'h5': 'feabas_tpu_torch._h5lite'}
    st, place, canvas = _results(wd, true_bb)      # read back with h5py
    assert len(st.matches) == 7
    assert np.abs(place - (true_bb[:, :2] - true_bb[0, :2])).max() < 0.5
    assert _render_cc(canvas, world) > 0.9
