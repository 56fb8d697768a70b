"""The port's alignment slice against the JAX package: the optimizer
additions (affine cascade, outcasts, disconnected split, huber_smooth),
the region block distributors and the section matcher on the same inputs,
and the whole align CLI on copies of one work dir. The port receives its
own meshes (rebuilt from the JAX meshes' init dicts through ``state``) and
its own loaders; work-dir files pass between the packages as they are."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from feabas_tpu import constant as const
from feabas_tpu import matcher as jmatcher
from feabas_tpu import optimizer as jopt
from feabas_tpu.dal import StaticImageLoader, StreamLoader
from feabas_tpu.mesh import Mesh
from feabas_tpu_torch import config as pconfig
from feabas_tpu_torch import dal as pdal
from feabas_tpu_torch import matcher, optimizer, state
from synthutil import texture

# the tier-1 run shares the cores among several pytest workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOVING, INITIAL, FIXED = (const.MESH_GEAR_MOVING, const.MESH_GEAR_INITIAL,
                          const.MESH_GEAR_FIXED)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU, asked for by name; the port's config caches start and end
    empty."""
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


def _p(mesh):
    """The port's copy of a JAX mesh."""
    return state.mesh_from_init_dict(mesh.get_init_dict())


def _mesh(opt, *args, **kwargs):
    """``Mesh.from_bbox`` of the JAX package, carried into the port when
    ``opt`` is the port's optimizer."""
    m = Mesh.from_bbox(*args, **kwargs)
    return m if opt is jopt else _p(m)


def _grid_pts(bbox, n=5, margin=2.0):
    xs = np.linspace(bbox[0] + margin, bbox[2] - margin, n)
    ys = np.linspace(bbox[1] + margin, bbox[3] - margin, n)
    xx, yy = np.meshgrid(xs, ys)
    return np.stack([xx.ravel(), yy.ravel()], -1)


@pytest.fixture()
def jax_eager_fused(monkeypatch):
    """Run the JAX package's fused match schedule eagerly. On these
    sections the jitted program stops its CG solves elsewhere than the
    eager one (ill-conditioned, partly unconstrained meshes) and moves
    border matches by up to ~1.3 px; the port agrees with the eager
    program to ~1e-7 px."""
    from feabas_tpu.ops import match_loop as jloop
    monkeypatch.setattr(jloop, 'fused_rounds', jloop._fused_rounds_core)


def _both(build):
    """Run ``build(optimizer_module)`` for the JAX package and the port."""
    return build(jopt), build(optimizer)


# ------------------------------ optimizer ------------------------------ #

def _smoothing_link(opt, off):
    m0 = _mesh(opt, (0, 0, 200, 200), cartesian=True, mesh_size=50, uid=0)
    m1 = _mesh(opt, (0, 0, 200, 200), cartesian=True, mesh_size=50, uid=1)
    pts = _grid_pts((0, 0, 200, 200), n=8, margin=10.0)
    link = opt.Link.from_coordinates(m0, m1, pts, pts + off,
                                     gear=(INITIAL, INITIAL))
    for m in (m0, m1):
        m.set_vertices(m.vertices(INITIAL), MOVING, offset=m.offset(INITIAL))
    return link


@pytest.mark.parametrize('mode', ['huber', 'huber_smooth', 'threshold'])
def test_residue_weights_match_jax(mode):
    """Link.adjust_weight_from_residue gives the JAX package's weights, for
    'huber_smooth' too (with dxy_smoothen)."""
    pts = _grid_pts((0, 0, 200, 200), n=8, margin=10.0)
    off = np.stack([6 * np.sin(pts[:, 1] / 60), 5 * np.cos(pts[:, 0] / 70)], -1)
    off[17] += (40.0, -35.0)
    want, got = _both(lambda opt: _smoothing_link(opt, off))
    assert np.allclose(got.dxy_smoothen(), want.dxy_smoothen(), atol=1e-9,
                       equal_nan=True)
    for link in (want, got):
        link.adjust_weight_from_residue(residue_len=3, residue_mode=mode)
    assert np.abs(got.residue_weight - want.residue_weight).max() < 1e-9


def _cascade_slm(opt, locked_first=True):
    """Four tiles in a row linked by known affines (and one isolated
    tile): tiles 1-3 must each move by the affine that lands their points
    on their left neighbour's."""
    from feabas_tpu.spatial import apply_affine
    meshes = [_mesh(opt, (80 * k, 0, 80 * k + 100, 100), cartesian=True,
                    mesh_size=25, uid=k, locked=(k == 0 and locked_first))
              for k in range(5)]
    slm = opt.SLM(meshes)
    rng = np.random.default_rng(4)
    for k in range(1, 4):
        T = np.eye(3)
        T[:2, :2] += rng.normal(0, 0.02, (2, 2))
        T[2, :2] = rng.normal(0, 3.0, 2)
        pts = _grid_pts((80 * k, 0, 80 * k + 20, 100))
        slm.add_link_from_coordinates(k - 1, k, apply_affine(pts, T), pts,
                                      weight=rng.uniform(0.5, 1.0, len(pts)))
    return slm


@pytest.mark.parametrize('groupings', [None, [0, 1, 1, 2, 3]])
def test_affine_cascade_matches_jax(groupings):
    kw = {} if groupings is None else {'groupings': groupings}
    for locked_first in (True, False):
        want, got = _both(lambda opt: _cascade_slm(opt, locked_first))
        r_want = want.optimize_affine_cascade(**kw)
        r_got = got.optimize_affine_cascade(**kw)
        assert abs(r_got - r_want) < 1e-9
        for a, b in zip(got.meshes, want.meshes):
            assert np.abs(a.vertices_w_offset(MOVING)
                          - b.vertices_w_offset(MOVING)).max() < 1e-9


def _split_slm(opt):
    anchor = _mesh(opt, (0, 0, 300, 100), cartesian=True, mesh_size=25,
                   uid=0, locked=True)
    broken = _mesh(opt, (0, 0, 300, 100), cartesian=True, mesh_size=25,
                   uid=1)
    cent = broken.triangle_centers('INITIAL')
    broken = broken.submesh(np.abs(cent[:, 0] - 150) > 20)
    broken.uid = 1.0
    lone = _mesh(opt, (0, 200, 100, 300), cartesian=True, mesh_size=25,
                 uid=2)
    slm = opt.SLM([anchor, broken, lone])
    ptsL = _grid_pts((10, 10, 120, 90), n=4)
    ptsR = _grid_pts((180, 10, 290, 90), n=4)
    slm.add_link_from_coordinates(0, 1, ptsL, ptsL - [4.0, 0.0])
    slm.add_link_from_coordinates(0, 1, ptsR, ptsR - [-3.0, 2.0])
    return slm, broken


def test_outcasts_and_disconnected_split_match_jax():
    (want, wb), (got, gb) = _both(_split_slm)
    assert list(got.flag_outcasts()) == list(want.flag_outcasts()) \
        == [False, False, True]
    assert got.divide_disconnected_submeshes() \
        == want.divide_disconnected_submeshes() == 1
    assert [m.uid for m in got.meshes] == [m.uid for m in want.meshes]
    assert len(got.links) == len(want.links) == 2
    for a, b in zip(got.links, want.links):
        assert a.uids == b.uids
        assert np.abs(a.weight() - b.weight()).max() < 1e-12
        assert np.abs(a.dxy(INITIAL) - b.dxy(INITIAL)).max() < 1e-9
    # move each component, then write the pieces back into the parent
    for slm in (got, want):
        for k, m in enumerate(slm.meshes[1:3]):
            m.set_vertices(m.vertices(FIXED), MOVING,
                           offset=m.offset(FIXED) + [k + 1.5, -k])
        slm.sync_component_positions()
    assert np.abs(gb.vertices_w_offset(MOVING)
                  - wb.vertices_w_offset(MOVING)).max() < 1e-9


def test_relax_mesh_most_deformed_matches_jax():
    def build(opt):
        m = _mesh(opt, (0, 0, 200, 200), cartesian=False, mesh_size=25)
        v = m.vertices(FIXED).copy()
        v[40] += (6.0, -5.0)
        m.set_vertices(v, MOVING, offset=m.offset(FIXED))
        return m
    want, got = _both(build)
    _, moved_w = jopt.relax_mesh_most_deformed(want)
    _, moved_g = optimizer.relax_mesh_most_deformed(got, dtype=torch.float64,
                                                    device='cpu')
    assert moved_g and moved_w
    assert np.abs(got.vertices_w_offset(MOVING)
                  - want.vertices_w_offset(MOVING)).max() < 1e-6


# ------------------------------ matching ------------------------------ #

def _section_pair(seed=42, drift=(6.0, -4.0), amp=2.0):
    """Two 320^2 sections (sec1 drifted and warped against sec0) and
    their equilateral meshes, mesh1 placed at the true drift."""
    import cv2
    rng = np.random.default_rng(seed)
    h = w = 320
    base = texture(rng, h + 80, w + 80)
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    imgs = []
    for z, d in enumerate(((0.0, 0.0), drift)):
        dx = d[0] + z * amp * np.sin(2 * np.pi * gy / 150.0)
        dy = d[1] + z * amp * np.cos(2 * np.pi * gx / 150.0)
        imgs.append(cv2.remap(base, gx + 40 + dx, gy + 40 + dy,
                              cv2.INTER_LINEAR))
    return imgs


def _section_meshes(split=False, port=False):
    """The two sections' meshes (the JAX package's, or the port's copies
    with ``port``)."""
    meshes = []
    for z in range(2):
        m = Mesh.from_bbox((0, 0, 320, 320), cartesian=False, mesh_size=30,
                           uid=z, locked=(z == 0))
        if split and z == 1:
            cent = m.triangle_centers('INITIAL')
            m = m.submesh(np.abs(cent[:, 0] - 160) > 12)
            m.uid = 1.0
        meshes.append(m)
    meshes[1].set_translation((-6.0, 4.0))
    return [_p(m) for m in meshes] if port else meshes


@pytest.mark.parametrize('distributor', ['cartesian_region',
                                         'intersect_triangulation'])
def test_distribute_matching_blocks_matches_jax(distributor):
    m0, m1 = _section_meshes(split=True)
    p0, p1 = _section_meshes(split=True, port=True)
    for mbd in (0, 20):
        kw = dict(distributor=distributor, min_boundary_distance=mbd,
                  render_weight_threshold=0.1,
                  stiffness_multiplier_threshold=0.1)
        c, f = matcher.distribute_matching_blocks(p0, p1, 50.0, **kw)
        jc, jf = jmatcher.distribute_matching_blocks(m0, m1, 50.0, **kw)
        assert c.shape[0] > 10
        assert np.array_equal(c, jc) and np.array_equal(f, jf)


_SEC_KW = dict(spacings=[100, 50, 25], sigma=2.5, conf_thresh=0.25,
               residue_len=3, min_boundary_distance=20,
               distributor='cartesian_region', shrink_factor=0.7,
               render_weight_threshold=0.1,
               stiffness_multiplier_threshold=0.1)


@pytest.mark.parametrize('case', ['fused', 'split', 'rendered_blocks'])
def test_section_matcher_matches_jax(case, tmp_path, jax_eager_fused):
    """Section matching in f64 on both sides: the fused schedule on
    in-memory sections, a section cut in two (each piece matched on its
    own) and on-disk sources, whose blocks render through MeshRenderer
    (the classic loop)."""
    imgs = _section_pair()
    if case == 'rendered_blocks':
        from feabas_tpu.common import imwrite
        loaders, ploaders = [], []
        for z, img in enumerate(imgs):
            fn = str(tmp_path / f's{z}.png')
            imwrite(fn, img)
            loaders.append(StaticImageLoader([fn], bboxes=[(0, 0, 320, 320)]))
            ploaders.append(pdal.StaticImageLoader(
                [fn], bboxes=[(0, 0, 320, 320)]))
    else:
        loaders = [StreamLoader(img) for img in imgs]
        ploaders = [pdal.StreamLoader(img) for img in imgs]
    jm = _section_meshes(split=case == 'split')
    pm = _section_meshes(split=case == 'split', port=True)
    want = jmatcher.section_matcher(jm[0], jm[1], *loaders, **dict(_SEC_KW))
    got = matcher.section_matcher(pm[0], pm[1], *ploaders, device='cpu',
                                  dtype=torch.float64, **dict(_SEC_KW))
    assert want is not None and got is not None
    assert got.xy0.shape == want.xy0.shape and got.xy0.shape[0] >= 20
    assert np.abs(got.xy0 - want.xy0).max() < 1e-3
    assert np.abs(got.xy1 - want.xy1).max() < 1e-3
    assert np.abs(got.weight - want.weight).max() < 1e-3


def test_match_from_initial_matches_matches_jax(tmp_path, jax_eager_fused):
    """Fine matching seeded by a coarse match file (affine cascade, then
    the section matcher), as the JAX package writes it."""
    from feabas_tpu import aligner as jal
    from feabas_tpu_torch import aligner as pal
    imgs = _section_pair()
    loaders = [StreamLoader(img) for img in imgs]
    ploaders = [pdal.StreamLoader(img) for img in imgs]
    mesh_dir = str(tmp_path / 'mesh')
    for z in range(2):
        Mesh.from_bbox((0, 0, 320, 320), cartesian=False, mesh_size=30,
                       resolution=4).save_to_h5(
            os.path.join(mesh_dir, f's{z}.h5'))
    pts = _grid_pts((40, 40, 280, 280), n=4)
    coarse = str(tmp_path / 'coarse' / jal.match_name('s0', 's1'))
    from feabas_tpu.common import Match
    jal.save_matches_to_h5(coarse, Match(pts + (6.0, -4.0), pts,
                                         np.ones(len(pts)), 0.01), 4)
    kw = dict(_SEC_KW, spacings=[100, 50])
    want = jal.match_section_from_initial_matches(
        coarse, mesh_dir, loaders, str(tmp_path / 'jax'),
        working_resolution=4, **dict(kw))
    got = pal.match_section_from_initial_matches(
        coarse, mesh_dir, ploaders, str(tmp_path / 'port'),
        working_resolution=4, **dict(kw))
    mw = jal.read_matches_from_h5(want)
    mp = pal.read_matches_from_h5(got)
    assert mp.xy0.shape == mw.xy0.shape and mp.xy0.shape[0] >= 20
    # the port's SLM solves in f32 here, the JAX package's in f64
    assert np.abs(mp.xy0 - mw.xy0).max() < 0.1
    assert np.abs(mp.xy1 - mw.xy1).max() < 0.1


def test_normalize_transforms_matches_jax(tmp_path):
    from feabas_tpu import aligner as jal
    from feabas_tpu_torch import aligner as pal
    out = {}
    for name, mod in (('jax', jal), ('port', pal)):
        tlist = []
        for z, (t, a) in enumerate((((5.0, -3.0), 0.1), ((-2.0, 7.0), 0.12))):
            m = Mesh.from_bbox((0, 0, 300, 200), cartesian=True, mesh_size=50,
                               resolution=4)
            T = np.eye(3)
            T[:2, :2] = [[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]]
            T[2, :2] = t
            m.set_vertices(m.vertices(FIXED), MOVING, offset=m.offset(FIXED))
            m.apply_affine(T, gear=(MOVING, MOVING))
            fn = str(tmp_path / name / f's{z}.h5')
            m.save_to_h5(fn)
            tlist.append(fn)
        bbox = mod.normalize_transforms(tlist, angle=None, offset=(0.0, 0.0))
        out[name] = (bbox, [Mesh.from_h5(t).vertices_w_offset(MOVING)
                            for t in tlist])
    assert out['port'][0] == out['jax'][0]
    for a, b in zip(out['port'][1], out['jax'][1]):
        assert np.abs(a - b).max() < 1e-9


# ------------------------------- the CLI ------------------------------- #

def _align_workdir(root, device_render=None, wrinkle=False):
    """The test_align_e2e fixture: three 320^2 'stitched' sections,
    cumulatively drifted and warped copies of one texture; with
    ``device_render`` the rendering stage is configured for the device
    lane (LINEAR remap); with ``wrinkle`` sections 1 and 2 carry a band
    of the shipped 'wrinkle' material (mask label 50, 32 px wide) in
    material masks at mip 2. Returns (config dir, work dir, names,
    drift)."""
    import cv2
    from feabas_tpu import storage
    from feabas_tpu.common import imwrite
    cfg = os.path.join(root, 'configs')
    shutil.copytree(os.path.join(REPO, 'configs'), cfg)
    wd = os.path.join(root, 'work_dir')
    storage.save_yaml(os.path.join(cfg, 'general_configs.yaml'), {
        'working_directory': wd, 'parallel_framework': 'serial',
        'full_resolution': 4, 'section_thickness': 30,
        'logfile_level': 'NONE', 'archive_level': 'NONE',
        'console_level': 'WARNING', 'cpu_budget': 2})
    rng = np.random.default_rng(42)
    h = w = 320
    base = texture(rng, h + 80, w + 80)
    drift = np.array([[0.0, 0.0], [6.0, -4.0], [-3.0, 8.0]])
    names = [f'sec{z:04d}' for z in range(3)]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    for z, name in enumerate(names):
        cum = drift[:z + 1].sum(axis=0)
        dx = cum[0] + z * 2.0 * np.sin(2 * np.pi * gy / 150.0)
        dy = cum[1] + z * 2.0 * np.cos(2 * np.pi * gx / 150.0)
        img = cv2.remap(base, (gx + 40 + dx).astype(np.float32),
                        (gy + 40 + dy).astype(np.float32), cv2.INTER_LINEAR)
        d = os.path.join(wd, 'stitched_sections', 'mip0', name)
        imwrite(os.path.join(d, name + '_tr1-tc1.png'), img)
        with storage.File(os.path.join(d, 'metadata.txt'), 'w') as f:
            f.write('{ROOT_DIR}\t' + d + '\n{RESOLUTION}\t4\n'
                    f'{name}_tr1-tc1.png\t0\t0\t{w}\t{h}\n')
        if wrinkle:
            mask = np.zeros((h // 4, w // 4), np.uint8)
            if z in (1, 2):
                c = 30 + 8 * z
                mask[:, c:c + 8] = 50
            imwrite(os.path.join(wd, 'align', 'material_masks',
                                 name + '.png'), mask)
    storage.save_yaml(os.path.join(wd, 'configs', 'alignment_configs.yaml'), {
        'meshing': {'mesh_size': 30, 'mask_mip_level': 2},
        'matching': {'working_mip_level': 0,
                     'matcher_config': {'spacings': [100, 50, 25],
                                        'conf_thresh': 0.25, 'sigma': 2.5,
                                        'min_boundary_distance': 20,
                                        'residue_len': 3}},
        'optimization': {'slide_window': {'window_size': 3, 'buffer_size': 1,
                                          'start_loc': 'L', 'residue_len': 3}},
        'rendering': {'tile_size': [512, 512],
                      'loader_config': {'apply_CLAHE': False,
                                        'inverse': False},
                      **({} if device_render is None else
                         {'device_render': device_render,
                          'remap_interp': 'LINEAR'})},
        'downsample': {'max_mip': 2, 'format': 'png'}})
    return cfg, wd, names, drift


def _run_cli(main, cfg, modes, monkeypatch):
    from feabas_tpu import config
    monkeypatch.setenv('FEABAS_TPU_CONFIG_DIR', cfg)
    config.clear_config_caches()
    pconfig.clear_config_caches()
    try:
        for mode in modes:
            main(['--mode', mode])
    finally:
        config.clear_config_caches()
        pconfig.clear_config_caches()


def _truth_error(m, drift):
    """|xy0 - truth| of sec0 -> sec1 matches (content at p in sec1 sits at
    p + drift[1] + warp1(p) in sec0)."""
    w1 = np.stack([2.0 * np.sin(2 * np.pi * m.xy1[:, 1] / 150.0),
                   2.0 * np.cos(2 * np.pi * m.xy1[:, 0] / 150.0)], -1)
    return np.linalg.norm(m.xy0 - (m.xy1 + drift[1] + w1), axis=-1)


def _overlay_cc(wd, names):
    from feabas_tpu.dal import StaticImageLoader as SIL
    out = os.path.join(wd, 'aligned_stack', 'mip0')
    rendered = [SIL.from_coordinate_file(os.path.join(
        out, f'{z:05d}_{n}', 'metadata.txt')).crop((0, 0, 320, 320))
        for z, n in enumerate(names)]
    inner = (slice(60, 260), slice(60, 260))
    ccs = []
    for z in (1, 2):
        a = rendered[0][inner].astype(np.float64).ravel()
        b = rendered[z][inner].astype(np.float64).ravel()
        ok = (a > 0) & (b > 0)
        ccs.append(np.corrcoef(a[ok], b[ok])[0, 1])
    return ccs


def test_port_align_cli_matches_jax(tmp_path, monkeypatch, jax_eager_fused):
    """meshing, matching, optimization, rendering and downsample through
    the port's CLI, against the JAX package's CLI on a copy of the same
    work dir."""
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    import align_main as jax_main
    from feabas_tpu_torch.aligner import match_name, read_matches_from_h5
    from feabas_tpu_torch.scripts import align_main as port_main
    cfg_j, wd_j, names, drift = _align_workdir(str(tmp_path / 'jax'))
    cfg_p, wd_p, _, _ = _align_workdir(str(tmp_path / 'port'))
    _run_cli(jax_main.main, cfg_j, ('meshing', 'matching', 'optimization'),
             monkeypatch)
    _run_cli(port_main.main, cfg_p, ('meshing', 'matching', 'optimization',
                                     'rendering', 'downsample'), monkeypatch)
    for a, b in zip(names[:-1], names[1:]):
        mp = read_matches_from_h5(os.path.join(wd_p, 'align', 'matches',
                                               match_name(a, b)))
        mj = read_matches_from_h5(os.path.join(wd_j, 'align', 'matches',
                                               match_name(a, b)))
        assert mp.xy0.shape[0] >= 6
        assert mp.xy0.shape == mj.xy0.shape
        assert np.abs(mp.xy0 - mj.xy0).max() < 0.1
        assert np.abs(mp.xy1 - mj.xy1).max() < 0.1
    m01 = read_matches_from_h5(os.path.join(wd_p, 'align', 'matches',
                                            match_name(names[0], names[1])))
    assert np.median(_truth_error(m01, drift)) < 1.0
    for n in names:
        tp = Mesh.from_h5(os.path.join(wd_p, 'align', 'tform', n + '.h5'))
        tj = Mesh.from_h5(os.path.join(wd_j, 'align', 'tform', n + '.h5'))
        assert np.abs(tp.vertices_w_offset(MOVING)
                      - tj.vertices_w_offset(MOVING)).max() < 0.1, n
    assert os.path.exists(os.path.join(wd_p, 'align', 'residues.csv'))
    # the window solves as one stacked system
    from feabas_tpu_torch.aligner import Stack
    stack = Stack(mesh_dir=os.path.join(wd_p, 'align', 'mesh'),
                  match_dir=os.path.join(wd_p, 'align', 'matches'),
                  resolution=4, device='cpu')
    stack.optimize_section_list(names, residue_len=3)
    assert stack.last_window_sharded
    assert min(_overlay_cc(wd_p, names)) > 0.85
    for z, n in enumerate(names):
        meta = os.path.join(wd_p, 'aligned_stack', 'mip2', f'{z:05d}_{n}',
                            'metadata.txt')
        blk = StaticImageLoader.from_coordinate_file(meta).crop((0, 0, 80, 80))
        assert blk is not None and blk.shape == (80, 80)


def _jax_groups_by_curve(monkeypatch):
    """Give the JAX package's meshes the port's element groups: its runs
    split where the stiffness curve changes, each with its own material's
    curve (the JAX package gives a run the curve of its first triangle's
    material)."""
    orig = Mesh.element_arrays

    def element_arrays(self, gear=INITIAL):
        uid2mat = self.material_table.uid_to_material()
        out = []
        for g in orig(self, gear=gear):
            ids = self.material_ids[g['start']:g['stop']]
            knots = {}
            for uid in np.unique(ids):
                mat = uid2mat.get(int(uid)) or self.material_table['default']
                if mat.stiffness_curve_knots() is not None:
                    knots[int(uid)] = mat.stiffness_curve_knots()
            curve = np.where(np.isin(ids, list(knots)), ids, -2)
            cuts = np.nonzero(np.diff(curve))[0] + 1
            for a, b in zip(np.r_[0, cuts], np.r_[cuts, ids.size]):
                out.append({**g, 'start': g['start'] + int(a),
                            'stop': g['start'] + int(b),
                            'tripts': g['tripts'][a:b],
                            'multiplier': g['multiplier'][a:b],
                            'poisson': g['poisson'][a:b],
                            'knots': knots.get(int(ids[a]))})
        return out
    monkeypatch.setattr(Mesh, 'element_arrays', element_arrays)


def test_port_align_cli_with_wrinkle_masks_matches_jax(tmp_path, monkeypatch,
                                                       jax_eager_fused):
    """Sections 1 and 2 carry a band of the shipped nonlinear 'wrinkle'
    material: matching takes the classic loop (the fused schedule refuses
    stiffness curves) and the window Newton-Raphson in place of the
    stacked solve, in both packages alike (the JAX package given the
    port's element groups); matches and tforms agree within 0.1 px."""
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    import align_main as jax_main
    from feabas_tpu_torch.aligner import (Stack, match_name,
                                          read_matches_from_h5)
    from feabas_tpu_torch.mesh import Mesh as PMesh
    from feabas_tpu_torch.ops import fem
    from feabas_tpu_torch.scripts import align_main as port_main
    _jax_groups_by_curve(monkeypatch)
    calls = [0]
    bind = fem.bind_elastic_operator

    def spy(*a, **k):
        op = bind(*a, **k)

        def counted(x):
            calls[0] += 1
            return op(x)
        return counted
    monkeypatch.setattr(fem, 'bind_elastic_operator', spy)
    cfg_j, wd_j, names, drift = _align_workdir(str(tmp_path / 'jax'),
                                               wrinkle=True)
    cfg_p, wd_p, _, _ = _align_workdir(str(tmp_path / 'port'), wrinkle=True)
    modes = ('meshing', 'matching', 'optimization')
    _run_cli(jax_main.main, cfg_j, modes, monkeypatch)
    _run_cli(port_main.main, cfg_p, modes[:2], monkeypatch)
    in_matching = calls[0]
    _run_cli(port_main.main, cfg_p, modes[2:], monkeypatch)
    assert in_matching > 0 and calls[0] > in_matching
    mesh = PMesh.from_h5(os.path.join(wd_p, 'align', 'mesh',
                                      names[1] + '.h5'))
    assert [g['knots'] is not None for g in mesh.element_arrays()] \
        == [False, True]
    for a, b in zip(names[:-1], names[1:]):
        mp = read_matches_from_h5(os.path.join(wd_p, 'align', 'matches',
                                               match_name(a, b)))
        mj = read_matches_from_h5(os.path.join(wd_j, 'align', 'matches',
                                               match_name(a, b)))
        assert mp.xy0.shape[0] >= 6
        assert mp.xy0.shape == mj.xy0.shape
        assert np.abs(mp.xy0 - mj.xy0).max() < 0.1
        assert np.abs(mp.xy1 - mj.xy1).max() < 0.1
    for n in names:
        tp = PMesh.from_h5(os.path.join(wd_p, 'align', 'tform', n + '.h5'))
        tj = Mesh.from_h5(os.path.join(wd_j, 'align', 'tform', n + '.h5'))
        assert np.abs(tp.vertices_w_offset(MOVING)
                      - tj.vertices_w_offset(MOVING)).max() < 0.1, n
        assert tp.flipped_triangles(MOVING).size == 0
    stack = Stack(mesh_dir=os.path.join(wd_p, 'align', 'mesh'),
                  match_dir=os.path.join(wd_p, 'align', 'matches'),
                  resolution=4, device='cpu')
    stack.optimize_section_list(names, residue_len=3)
    assert stack.last_window_sharded is False


def test_port_align_cli_refuses_tensorstore(tmp_path, monkeypatch):
    """Without tensorstore (the port's ``_tslite`` bound in its place) the
    volume modes refuse what only tensorstore serves, naming it: ``tsr``
    into zarr (blosc), and ``tsd`` of a volume that is not there."""
    from feabas_tpu import storage
    from feabas_tpu_torch import _tslite
    from feabas_tpu_torch.scripts import align_main as port_main
    monkeypatch.setattr(pdal, 'ts', _tslite)
    cfg, wd, names, _ = _align_workdir(str(tmp_path))
    _run_cli(port_main.main, cfg, ('meshing',), monkeypatch)
    shutil.copytree(os.path.join(wd, 'align', 'mesh'),
                    os.path.join(wd, 'align', 'tform'))
    conf_path = os.path.join(wd, 'configs', 'alignment_configs.yaml')
    conf = storage.load_yaml(conf_path)
    conf['tensorstore_rendering'] = {'driver': 'zarr'}
    storage.save_yaml(conf_path, conf)
    with pytest.raises(_tslite.UnsupportedSpec, match='zarr.*blosc'):
        _run_cli(port_main.main, cfg, ('tsr',), monkeypatch)
    with pytest.raises(ValueError, match='NOT_FOUND'):
        _run_cli(port_main.main, cfg, ('tsd',), monkeypatch)


def test_port_align_cli_runs_chunked_optimization(tmp_path, monkeypatch):
    """``align_main --mode optimization`` with ``chunked_to_depth: 1`` (chunks
    of 2 over the three sections) writes every tform, the chunk map marks
    every chunk committed, no tform holds a flipped triangle and every
    pair's median residue is under 1 px."""
    from feabas_tpu import storage
    from feabas_tpu_torch.mesh import Mesh as PMesh
    from feabas_tpu_torch.scripts import align_main as port_main
    cfg, wd, names, drift = _align_workdir(str(tmp_path))
    _run_cli(port_main.main, cfg, ('meshing', 'matching'), monkeypatch)
    conf_path = os.path.join(wd, 'configs', 'alignment_configs.yaml')
    conf = storage.load_yaml(conf_path)
    conf['optimization']['chunk_settings'] = {
        'chunked_to_depth': 1, 'default_chunk_size': 2, 'junction_width': 1,
        'pad_junctional': True}
    storage.save_yaml(conf_path, conf)
    _run_cli(port_main.main, cfg, ('optimization',), monkeypatch)
    with open(os.path.join(wd, 'align', 'chunked_tform', 'depth1',
                           'chunk_map.json')) as f:
        chunks = json.load(f)['chunks']
    assert [c['sections'] for c in chunks] == [names[:2], names[2:]]
    assert all(c['committed'] for c in chunks)
    for n in names:
        t = PMesh.from_h5(os.path.join(wd, 'align', 'tform', n + '.h5'))
        assert t.flipped_triangles(MOVING).size == 0, n
    with open(os.path.join(wd, 'align', 'residues.csv')) as f:
        rows = [r.split(',') for r in f.read().split()[1:]]
    assert len(rows) == len(names) - 1
    assert max(float(r[3]) for r in rows) < 1.0, rows


_SUBPROCESS = r'''
import json, sys
sys.modules['h5py'] = None          # a host without h5py
from feabas_tpu_torch.scripts import align_main
for mode in ('meshing', 'matching', 'optimization', 'rendering'):
    align_main.main(['--mode', mode])
print(json.dumps({'jax': sorted(m for m in sys.modules
                                if m == 'jax' or m.startswith('jax.')),
                  'feabas_tpu': sorted(m for m in sys.modules
                                       if m == 'feabas_tpu'
                                       or m.startswith('feabas_tpu.'))}))
'''


def test_port_align_alone_imports_no_jax(tmp_path):
    """A fresh interpreter runs the port's align CLI end to end, rendering
    through the device lane (the plain raster on the CPU), without
    importing jax or the JAX package."""
    cfg, wd, names, drift = _align_workdir(str(tmp_path), device_render=True)
    env = dict(os.environ, FEABAS_TPU_CONFIG_DIR=cfg, FEABAS_TORCH_DEVICE='cpu',
               PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    proc = subprocess.run([sys.executable, '-c', _SUBPROCESS], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {'jax': [], 'feabas_tpu': []}
    assert min(_overlay_cc(wd, names)) > 0.85
