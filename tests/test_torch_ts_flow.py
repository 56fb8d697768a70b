"""tests/test_ts_flow_e2e.py through the port's three drivers: stitch
sections rendered into per-section volumes (no PNG tiles), thumbnails
straight from the volumes, align matching and rendering off volume
loaders, held to the JAX test's own checks; then ``align_main --mode
tsr`` (the aligned stack into one volume, which the JAX package reads,
resumed without a write) and ``--mode tsd`` (its mip scales, equal to a
numpy mean of the base). On neuroglancer-precomputed with either store the
port binds (tensorstore, the port's ``_tslite``), and on zarr where
tensorstore is there, as the JAX test runs."""

import json
import os

import numpy as np
import pytest
import tensorstore as ts
import torch

from feabas_tpu import dal as jdal
from feabas_tpu_torch import _tslite
from feabas_tpu_torch import config as pconfig
from feabas_tpu_torch import dal as pdal
from feabas_tpu_torch import storage
from feabas_tpu_torch.common import imread, imwrite

from synthutil import texture

torch.set_num_threads(1)

DRIFT = np.array([[0.0, 0.0], [9.0, -6.0], [-5.0, 8.0]])
TILE_H, TILE_W, OVERLAP = 180, 200, 60
SEC_H, SEC_W = TILE_H, 2 * TILE_W - OVERLAP
MARKER = {'zarr': '.zarray', 'neuroglancer_precomputed': 'info'}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


def _layout(workdir, rng, driver):
    """The JAX test's three sections (1x2 jittered tile grids cut from a
    drifted view of one texture) and its overrides, with the stitch
    volumes in ``driver`` and the tsr/tsd settings of this test."""
    margin = 40
    base = texture(rng, SEC_H + 2 * margin, SEC_W + 2 * margin, blur=3)
    names = [f's{z:04d}' for z in range(3)]
    cums = np.cumsum(DRIFT, axis=0)
    for z, name in enumerate(names):
        oy, ox = margin + int(cums[z][1]), margin + int(cums[z][0])
        view = base[oy:oy + SEC_H, ox:ox + SEC_W]
        tdir = workdir / 'raw' / name
        lines = ['{ROOT_DIR}\t' + str(tdir), '{RESOLUTION}\t4']
        for c in range(2):
            x0 = c * (TILE_W - OVERLAP)
            jx, jy = (0, 0) if c == 0 else \
                np.round(rng.normal(0, 2.0, 2)).astype(int)
            xt = int(np.clip(x0 + jx, 0, SEC_W - TILE_W))
            yt = int(np.clip(jy, 0, SEC_H - TILE_H))
            fn = f'{name}_tr1-tc{c + 1}.png'
            imwrite(str(tdir / fn), view[yt:yt + TILE_H, xt:xt + TILE_W])
            lines.append(f'{fn}\t{x0}\t0\t{x0 + TILE_W}\t{TILE_H}')
        with storage.File(str(workdir / 'stitch' / 'stitch_coord'
                              / (name + '.txt')), 'w') as f:
            f.write('\n'.join(lines) + '\n')
    cfg = workdir / 'configs'
    storage.save_yaml(str(cfg / 'stitching_configs.yaml'), {
        'matching': {'matcher_config': {'coarse_downsample': 1.0,
                                        'conf_thresh': 0.25}},
        'rendering': {'driver': driver, 'read_chunk_size': [128, 128],
                      'loader_settings': {'apply_CLAHE': False,
                                          'inverse': False}}})
    storage.save_yaml(str(cfg / 'thumbnail_configs.yaml'), {
        'thumbnail_mip_level': 1,
        'downsample': {'thumbnail_highpass': True,
                       'highpass_inter_mip_lvl': 0},
        'alignment': {
            'compare_distance': 1,
            'feature_matching': {'detect_settings': {
                'sigma': 2.5, 'min_spacing': 4, 'num_features': 2000}},
            'block_matching': {'spacings': [40, 20], 'conf_thresh': 0.25,
                               'sigma': 2.5},
            'optimization': {
                'meshing_config': {'mesh_size': 40},
                'slide_window': {'window_size': 3, 'buffer_size': 1,
                                 'start_loc': 'L', 'residue_len': 2}}}})
    storage.save_yaml(str(cfg / 'alignment_configs.yaml'), {
        'meshing': {'mesh_size': 40},
        'matching': {'working_mip_level': 0,
                     'matcher_config': {'spacings': [80, 40],
                                        'conf_thresh': 0.25, 'sigma': 2.5,
                                        'min_boundary_distance': 15,
                                        'residue_len': 3}},
        'optimization': {'slide_window': {'window_size': 3, 'buffer_size': 1,
                                          'start_loc': 'L',
                                          'residue_len': 3}},
        'rendering': {'tile_size': [512, 512], 'remap_interp': 'LINEAR',
                      'device_render': False,
                      'loader_config': {'apply_CLAHE': False,
                                        'inverse': False}},
        'tensorstore_rendering': {'chunk_shape': [128, 128, 2],
                                  'remap_interp': 'LINEAR',
                                  'device_render': False},
        'tensorstore_downsample': {'jpeg_compression': None}})
    pconfig.clear_config_caches()
    return names


def _half_even_mean(a, f):
    """Mean of each f-block of ``a`` (x, y, z), partial edge blocks over
    the voxels there, rounded half to even (tensorstore's uint8 mean)."""
    out_shape = [-(-s // k) for s, k in zip(a.shape, f)]
    pad = [(0, o * k - s) for s, k, o in zip(a.shape, f, out_shape)]
    ap = np.pad(a.astype(np.int64), pad)
    blocks = ap.reshape([v for o, k in zip(out_shape, f) for v in (o, k)])
    total = blocks.sum(axis=(1, 3, 5))
    count = np.pad(np.ones(a.shape, np.int64), pad).reshape(
        blocks.shape).sum(axis=(1, 3, 5))
    return np.round(total / count).astype(a.dtype)   # numpy rounds half even


@pytest.mark.parametrize('driver, store', [
    ('neuroglancer_precomputed', 'tensorstore'),
    ('neuroglancer_precomputed', '_tslite'),
    ('zarr', 'tensorstore')])
def test_tensorstore_section_flow(workdir, rng, monkeypatch, driver, store):
    from feabas_tpu_torch.aligner import match_name, read_matches_from_h5
    from feabas_tpu_torch.dal import StaticImageLoader
    from feabas_tpu_torch.scripts import align_main, stitch_main, \
        thumbnail_main
    monkeypatch.setattr(pdal, 'ts', ts if store == 'tensorstore' else _tslite)
    names = _layout(workdir, rng, driver)
    join = storage.join_paths

    # --- stitch: match + optimize + render to per-section volumes ---
    for mode in ('matching', 'optimization', 'rendering'):
        stitch_main.main(['--mode', mode])
    sec_root = join(str(workdir), 'stitched_sections', 'mip0')
    for n in names:
        d = join(sec_root, n)
        assert storage.file_exists(join(d, MARKER[driver])), n
        assert not storage.file_exists(join(d, 'metadata.txt'))
    vol = ts.open({'driver': driver, 'kvstore': {
        'driver': 'file', 'path': join(sec_root, names[0])}}).result()
    assert vol.shape[0] >= SEC_W - 4 and vol.shape[1] >= SEC_H - 4

    # --- thumbnails straight from the volumes (downsample views) ---
    thumbnail_main.main(['--mode', 'downsample'])
    for n in names:
        assert storage.file_exists(join(str(workdir), 'thumbnail_align',
                                        'thumbnails', n + '.png')), n
    t0 = imread(join(str(workdir), 'thumbnail_align', 'thumbnails',
                     names[0] + '.png'))
    pad_w = int(np.ceil(SEC_W / 128)) * 128
    assert abs(t0.shape[1] - pad_w // 2) <= 3, t0.shape
    assert not storage.file_exists(join(str(workdir), 'stitched_sections',
                                        'mip1', names[0], 'metadata.txt'))

    # --- thumbnail matching recovers the coarse drift ---
    thumbnail_main.main(['--mode', 'matching'])
    for z in (1, 2):
        m = read_matches_from_h5(
            join(str(workdir), 'thumbnail_align', 'matches',
                 match_name(names[z - 1], names[z])), target_resolution=4)
        d = np.median(m.xy0 - m.xy1, axis=0)
        assert np.allclose(d, DRIFT[z], atol=2.5), (z, d, DRIFT[z])
    thumbnail_main.main(['--mode', 'optimization'])

    # --- align: mesh/match/optimize/render off the volume loaders ---
    align_main.main(['--mode', 'meshing'])
    align_main.main(['--mode', 'matching'])
    m01 = read_matches_from_h5(join(str(workdir), 'align', 'matches',
                                    match_name(names[0], names[1])))
    assert m01.xy0.shape[0] >= 6
    err = np.linalg.norm(m01.xy0 - (m01.xy1 + DRIFT[1]), axis=-1)
    assert np.median(err) < 1.0, np.median(err)
    align_main.main(['--mode', 'optimization'])
    for n in names:
        assert storage.file_exists(join(str(workdir), 'align', 'tform',
                                        n + '.h5'))
    align_main.main(['--mode', 'rendering'])
    with open(join(str(workdir), 'align', 'tform', 'canvas.json')) as f:
        canvas = json.load(f)['mip0']
    out_root = join(str(workdir), 'aligned_stack', 'mip0')
    rendered = [StaticImageLoader.from_coordinate_file(
        join(out_root, f'{z:05d}_{n}', 'metadata.txt')).crop(canvas)
        for z, n in enumerate(names)]
    inner = (slice(40, SEC_H - 40), slice(40, SEC_W - 40))
    for z in (1, 2):
        a = rendered[0][inner].astype(np.float64).ravel()
        b = rendered[z][inner].astype(np.float64).ravel()
        ok = (a > 0) & (b > 0)
        assert np.corrcoef(a[ok], b[ok])[0, 1] > 0.85, z

    # --- tsr: the aligned stack into one volume, read by the JAX package
    align_main.main(['--mode', 'tsr'])
    tdir = join(str(workdir), 'aligned_tensorstore')
    spec = {'driver': 'neuroglancer_precomputed',
            'kvstore': {'driver': 'file', 'path': tdir}}
    W, H = canvas[2] - canvas[0], canvas[3] - canvas[1]
    for z in range(3):
        layer = jdal.TensorStoreLoader(spec, z=z).crop((0, 0, W, H))
        d = np.abs(layer.astype(int) - rendered[z].astype(int))
        assert d.max() <= 1, (z, d.max(), (d > 0).mean())
    chunk_files = sorted(
        os.path.join(r, f) for r, _, fs in os.walk(join(tdir, '4_4_30'))
        for f in fs)
    mtimes = [os.stat(p).st_mtime_ns for p in chunk_files]
    align_main.main(['--mode', 'tsr'])          # resumed: nothing written
    assert [os.stat(p).st_mtime_ns for p in chunk_files] == mtimes

    # --- tsd: its mip scales, each a half-to-even mean of the base ---
    align_main.main(['--mode', 'tsd'])
    with open(join(tdir, 'info')) as f:
        scales = json.load(f)['scales']
    assert [s['key'] for s in scales] == \
        ['4_4_30', '8_8_30', '32_32_30', '128_128_90', '512_512_90']
    base = ts.open(spec).result().read().result()[..., 0]
    for idx, f in enumerate([(2, 2, 1), (8, 8, 1), (32, 32, 3),
                             (128, 128, 3)], start=1):
        got = ts.open(dict(spec, scale_index=idx)).result().read().result()
        assert np.array_equal(got[..., 0], _half_even_mean(base, f)), idx
