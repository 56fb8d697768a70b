"""The port stands alone: no file of it imports the JAX package, a fresh
interpreter without h5py and tensorstore imports every module of it,
stitches and renders a volume (which the JAX package reads) without
importing jax or the JAX package, its copies of the host plane agree with
the JAX package's, the work-dir files pass between the two packages both
ways, and its device is the CUDA card unless the CPU is asked for."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from feabas_tpu import aligner as jaligner
from feabas_tpu import common as jcommon
from feabas_tpu import stitcher as jstitcher
from feabas_tpu.mesh import Mesh as JMesh
import feabas_tpu_torch
from feabas_tpu_torch import aligner as paligner
from feabas_tpu_torch import common as pcommon
from feabas_tpu_torch import config as pconfig
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch import material as pmaterial
from feabas_tpu_torch import state
from feabas_tpu_torch import stitcher as pstitcher
from feabas_tpu_torch.mesh import Mesh as PMesh
from synthutil import tile_grid

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'feabas_tpu_torch')


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU, asked for by name; the port's config caches start and end
    empty."""
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


# ----------------------------- no JAX import ----------------------------- #

def _imported_modules(path):
    """Every absolute module an import statement of ``path`` names, lazy
    imports inside functions included, with its line."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def test_no_file_of_the_port_imports_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith('.py')]
    files.append(os.path.join(REPO, 'chip_smoke.py'))
    assert len(files) > 40
    bad = [f'{os.path.relpath(f, REPO)}:{line} {mod}'
           for f in files for line, mod in _imported_modules(f)
           if mod.split('.')[0] in ('feabas_tpu', 'jax', 'jaxlib')]
    assert bad == []


_ALONE = r'''
import hashlib, importlib, json, os, pkgutil, sys
import numpy as np
sys.modules['h5py'] = None          # a host without h5py
sys.modules['tensorstore'] = None   # nor tensorstore
import feabas_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(feabas_tpu_torch.__path__,
                                              'feabas_tpu_torch.')]
for name in mods:
    importlib.import_module(name)
from feabas_tpu_torch import common, config, material, storage
from feabas_tpu_torch.scripts import stitch_main
table = config.material_table()
factory = common.str_to_func('feabas_tpu.material::asymmetrical_elasticity')
for mode in ('matching', 'optimization', 'rendering'):
    stitch_main.main(['--mode', mode])
# a two-section volume through the port's own store
from feabas_tpu_torch import dal
from feabas_tpu_torch.mesh import Mesh
from feabas_tpu_torch.renderer import VolumeRenderer
vol_dir = os.path.join(config.get_work_dir(), 'volume')
writer = dal.TensorStoreWriter.create(vol_dir, (0, 0, 100, 70), 2,
                                      chunk_shape=[32, 32, 2])
tforms, loaders = [], {}
for z in range(2):
    img = np.random.default_rng(9 + z).integers(0, 256, (60, 80)).astype(
        np.uint8)
    mesh = Mesh.from_bbox((0, 0, 80, 60), cartesian=True, mesh_size=30,
                          name=f's{z}', uid=z)
    mesh.set_translation((3 + 4 * z, 5))
    tforms.append((z, f's{z}', mesh))
    loaders[f's{z}'] = dal.StreamLoader(img)
n_chunks = VolumeRenderer(tforms, loaders, writer,
                          device_render=False).render_volume()
vol = dal.ts.open({'driver': 'neuroglancer_precomputed', 'kvstore': {
    'driver': 'file', 'path': vol_dir}}).result()[..., 0].read().result()
print(json.dumps({
    'ts': dal.ts.__name__, 'volume': vol_dir, 'chunks': n_chunks,
    'voxels': hashlib.sha256(np.ascontiguousarray(vol).tobytes()).hexdigest(),
    'modules': len(mods),
    'thumbnail_modules': sorted(m for m in mods if m.endswith(
        ('.thumbnail', '.ops.lradon', '.scripts.thumbnail_main'))),
    'h5': storage.h5py.__name__,
    'wrinkle_is_nonlinear': table['wrinkle'].stiffness_func is not None,
    'factory_is_the_ports': factory is material.asymmetrical_elasticity,
    'jax': sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')),
    'feabas_tpu': sorted(m for m in sys.modules
                         if m == 'feabas_tpu' or m.startswith('feabas_tpu.'))}))
'''


def _stitch_workdir(root, rows=1, cols=2):
    """A config dir + work dir with one tiny section, written with the
    port's own host plane. Returns (config dir, work dir, true bboxes)."""
    import shutil
    from feabas_tpu_torch import storage
    rng = np.random.default_rng(5)
    world, tiles, true_bb, stage_bb = tile_grid(
        rng, rows=rows, cols=cols, tile_h=160, tile_w=200, overlap=40,
        jitter=3.0)
    cfg = os.path.join(root, 'configs')
    shutil.copytree(os.path.join(REPO, 'configs'), cfg)
    wd = os.path.join(root, 'work_dir')
    storage.save_yaml(os.path.join(cfg, 'general_configs.yaml'), {
        'working_directory': wd, 'parallel_framework': 'serial',
        'full_resolution': 4, 'logfile_level': 'NONE',
        'archive_level': 'NONE', 'console_level': 'WARNING', 'cpu_budget': 2})
    tdir = os.path.join(wd, 'raw', 's0001')
    lines = ['{ROOT_DIR}\t' + tdir, '{RESOLUTION}\t4']
    for k, (tile, sb) in enumerate(zip(tiles, stage_bb)):
        pcommon.imwrite(os.path.join(tdir, f't{k}.png'), tile)
        lines.append(f't{k}.png\t{sb[0]:.0f}\t{sb[1]:.0f}\t{sb[2]:.0f}\t'
                     f'{sb[3]:.0f}')
    with storage.File(os.path.join(wd, 'stitch', 'stitch_coord',
                                   's0001.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    storage.save_yaml(os.path.join(wd, 'configs', 'stitching_configs.yaml'), {
        'matching': {'matcher_config': {'coarse_downsample': 1.0,
                                        'conf_thresh': 0.25}},
        'rendering': {'loader_settings': {'apply_CLAHE': False,
                                          'inverse': False}}})
    return cfg, wd, true_bb


def test_port_alone_imports_every_module_and_stitches(tmp_path):
    """Without h5py, tensorstore and the JAX package: every module of the
    port imports, the default material table loads (its nonlinear
    material names ``feabas_tpu.material``), the stitch CLI runs end to
    end, and ``VolumeRenderer`` writes a precomputed volume through
    ``_tslite``; neither jax nor any ``feabas_tpu`` module gets imported."""
    cfg, wd, true_bb = _stitch_workdir(str(tmp_path))
    env = dict(os.environ, FEABAS_TPU_CONFIG_DIR=cfg,
               FEABAS_TORCH_DEVICE='cpu', PYTHONPATH=REPO,
               OMP_NUM_THREADS='1')
    proc = subprocess.run([sys.executable, '-c', _ALONE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    n_mods = len(list(pkgutil.walk_packages(feabas_tpu_torch.__path__,
                                            'feabas_tpu_torch.')))
    # the JAX package, with tensorstore, reads the port's volume: the same
    # voxels, each section at its integer translation
    import hashlib
    from feabas_tpu.dal import TensorStoreLoader
    spec = {'driver': 'neuroglancer_precomputed',
            'kvstore': {'driver': 'file', 'path': out.pop('volume')}}
    vol = np.stack([TensorStoreLoader(spec, z=z).crop((0, 0, 100, 70)).T
                    for z in range(2)], -1)
    assert hashlib.sha256(vol.tobytes()).hexdigest() == out.pop('voxels')
    for z in range(2):
        img = np.random.default_rng(9 + z).integers(0, 256, (60, 80))
        x0 = 3 + 4 * z
        assert np.array_equal(vol[x0 + 1:x0 + 79, 6:64, z].T,
                              img[1:59, 1:79])
    assert out.pop('chunks') == 9           # the chunks the sections meet
    assert out.pop('ts') == 'feabas_tpu_torch._tslite'
    assert out == {'modules': n_mods,
                   'thumbnail_modules': [
                       'feabas_tpu_torch.ops.lradon',
                       'feabas_tpu_torch.scripts.thumbnail_main',
                       'feabas_tpu_torch.thumbnail'],
                   'h5': 'feabas_tpu_torch._h5lite',
                   'wrinkle_is_nonlinear': True, 'factory_is_the_ports': True,
                   'jax': [], 'feabas_tpu': []}
    # the JAX package reads what the port wrote there without h5py
    st = jstitcher.Stitcher.from_h5(os.path.join(wd, 'stitch', 'match_h5',
                                                 's0001.h5'))
    assert list(st.matches) == [(0, 1)]
    st = jstitcher.Stitcher.from_h5(os.path.join(wd, 'stitch', 'tform',
                                                 's0001.h5'))
    origins = np.asarray([m.vertices_w_offset('MOVING').mean(axis=0)
                          - m.vertices_w_offset('INITIAL').mean(axis=0)
                          for m in st.meshes])
    truth = true_bb[:, :2] - true_bb[0, :2]
    assert np.abs((origins - origins[0]) - truth).max() < 0.5


# ------------------------- the copied host plane ------------------------- #

def test_function_strings_name_the_jax_module_and_resolve_in_the_port():
    """Work-dir files name functions under ``feabas_tpu.``: the port writes
    the same strings and reads them as its own functions."""
    name = 'feabas_tpu.material::asymmetrical_elasticity'
    assert pcommon.str_to_func(name) is pmaterial.asymmetrical_elasticity
    assert pcommon.str_to_func('feabas_tpu.material.asymmetrical_elasticity') \
        is pmaterial.asymmetrical_elasticity
    assert pcommon.func_to_str(pmaterial.asymmetrical_elasticity) == name
    assert jcommon.func_to_str(jcommon.str_to_func(name)) == name
    assert pcommon.func_to_str(np.linalg.norm) == \
        jcommon.func_to_str(np.linalg.norm)
    f = pcommon.str_to_func(name, strain=(0.0, 1.0), stiffness=(2.0, 1.0))
    g = jcommon.str_to_func(name, strain=(0.0, 1.0), stiffness=(2.0, 1.0))
    x = np.linspace(0, 2, 9)
    assert np.array_equal(np.asarray(f(x)), np.asarray(g(x)))


def _jax_mesh(cartesian, seed=0):
    """A JAX-package mesh with every gear the init dict carries: moving
    vertices, a wrinkle (nonlinear) region, a soft region and per-triangle
    stiffness."""
    rng = np.random.default_rng(seed)
    m = JMesh.from_bbox((0, 0, 300, 200), cartesian=cartesian, mesh_size=40,
                        resolution=4, uid=3, name='sec3')
    mt = m.material_table
    cent = m.triangle_centers('INITIAL')
    ids = np.full(len(cent), mt['default'].uid)
    ids[cent[:, 0] > 200] = mt['wrinkle'].uid
    ids[cent[:, 1] > 150] = mt['soft'].uid
    init = m.get_init_dict()
    init.update(material_ids=ids,
                stiffness_multiplier=rng.uniform(0.5, 2.0, len(cent)),
                initial_offset=np.array([[10.5, -3.25]]))
    m = JMesh(init.pop('vertices'), init.pop('triangles'), **init)
    v = m.vertices('INITIAL')
    m.set_vertices(v + rng.normal(0, 1.0, v.shape), 'MOVING',
                   offset=m.offset('INITIAL') + [2.0, 1.0])
    return m


@pytest.mark.parametrize('cartesian', [True, False])
def test_mesh_from_init_dict_equals_the_jax_mesh(cartesian):
    jm = _jax_mesh(cartesian)
    pm = state.mesh_from_init_dict(jm.get_init_dict())
    assert isinstance(pm, PMesh)
    assert np.array_equal(pm.triangles, jm.triangles)
    assert np.array_equal(pm.material_ids, jm.material_ids)
    for gear in ('INITIAL', 'FIXED', 'MOVING'):
        assert np.array_equal(pm.vertices(gear), jm.vertices(gear))
        assert np.array_equal(pm.offset(gear), jm.offset(gear))
    assert (pm.uid, pm.name, pm.resolution, pm.locked) == \
        (jm.uid, jm.name, jm.resolution, jm.locked)
    pe, je = pm.element_arrays(), jm.element_arrays()
    for k in ('tripts', 'multiplier', 'poisson'):
        assert np.array_equal(np.concatenate([a[k] for a in pe]),
                              np.concatenate([b[k] for b in je])), k
    wrinkle = jm.material_table['wrinkle']
    pk = pm.material_table['wrinkle'].stiffness_curve_knots()
    jk = wrinkle.stiffness_curve_knots()
    assert all(np.array_equal(a, b) for a, b in zip(pk, jk))
    # the JAX package's one ENG run splits where the stiffness curve
    # changes: the wrinkle triangles form their own group with its curve
    # (the JAX package's run takes its first triangle's: none)
    w0 = int(np.argmax(jm.material_ids == wrinkle.uid))
    assert [(b['model'], b['start'], b['stop'], b['knots']) for b in je] \
        == [(0, 0, jm.num_triangles, None)]
    assert [(a['model'], a['start'], a['stop']) for a in pe] == \
        [(0, 0, w0), (0, w0, jm.num_triangles)]
    assert pe[0]['knots'] is None
    assert all(np.array_equal(a, b) for a, b in zip(pe[1]['knots'], jk))
    # the port's mesh owns its arrays
    pm.vertices('MOVING')[0] += 1.0
    assert not np.array_equal(pm.vertices('MOVING'), jm.vertices('MOVING'))


def test_match_from_arrays_is_the_ports_match():
    rng = np.random.default_rng(1)
    jm = jcommon.Match(rng.random((6, 2)), rng.random((6, 2)), rng.random(6),
                       0.02)
    pm = state.match_from_arrays(*jm)
    assert isinstance(pm, pcommon.Match) and pm.strain == 0.02
    for a, b in zip(pm[:3], jm[:3]):
        assert np.array_equal(a, b)
    assert state.match_from_arrays(*jm[:3]).strain == \
        pconfig.DEFAULT_AVG_DEFORM


def _write(pkg, kind, path, rng):
    """Write one work-dir file of ``kind`` with package ``pkg``; returns
    what the file holds."""
    if kind == 'mesh':
        m = _jax_mesh(False, seed=2)
        if pkg == 'port':
            m = state.mesh_from_init_dict(m.get_init_dict())
        m.save_to_h5(path)
        return m
    if kind == 'match':
        Match, mod = ((jcommon.Match, jaligner) if pkg == 'jax'
                      else (pcommon.Match, paligner))
        match = Match(rng.random((7, 2)) * 100, rng.random((7, 2)) * 100,
                      rng.random(7), 0.03)
        mod.save_matches_to_h5(path, match, 8.0)
        return match
    bboxes = [(0, 0, 200, 160), (150, 0, 350, 160), (300, 2, 500, 162)]
    if pkg == 'jax':
        st = jstitcher.Stitcher([f't{k}.png' for k in range(3)], bboxes,
                                root_dir='/x', resolution=4, name='s1')
        Match = jcommon.Match
    else:
        st = pstitcher.Stitcher([f't{k}.png' for k in range(3)], bboxes,
                                root_dir='/x', resolution=4, name='s1',
                                device='cpu')
        Match = pcommon.Match
    st.matches[(0, 1)] = Match(rng.random((5, 2)), rng.random((5, 2)),
                               rng.random(5), 0.01)
    st.initialize_meshes()
    for k, m in enumerate(st.meshes):
        m.set_vertices(m.vertices('FIXED') + k, 'MOVING',
                       offset=m.offset('FIXED'))
    st.save_to_h5(path)
    return st


def _read(pkg, kind, path):
    if kind == 'mesh':
        return (JMesh if pkg == 'jax' else PMesh).from_h5(path)
    if kind == 'match':
        return (jaligner if pkg == 'jax' else paligner).read_matches_from_h5(
            path)
    if pkg == 'jax':
        return jstitcher.Stitcher.from_h5(path)
    return pstitcher.Stitcher.from_h5(path, device='cpu')


def _assert_same_mesh(a, b):
    assert np.array_equal(a.triangles, b.triangles)
    assert np.array_equal(a.material_ids, b.material_ids)
    for gear in ('INITIAL', 'FIXED', 'MOVING'):
        assert np.array_equal(a.vertices_w_offset(gear),
                              b.vertices_w_offset(gear))
    assert (a.uid, a.name, a.locked) == (b.uid, b.name, b.locked)
    # over every group: the port's groups split where the stiffness curve
    # changes, the JAX package's do not
    assert np.array_equal(
        np.concatenate([x['multiplier'] for x in a.element_arrays()]),
        np.concatenate([y['multiplier'] for y in b.element_arrays()]))


@pytest.mark.parametrize('kind', ['mesh', 'match', 'tform'])
@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_work_dir_files_interchange(writer, kind, tmp_path):
    """A mesh H5, a match H5 and a stitch tform H5 written by one package
    read back in the other with equal arrays."""
    reader = 'port' if writer == 'jax' else 'jax'
    path = str(tmp_path / f'{kind}.h5')
    wrote = _write(writer, kind, path, np.random.default_rng(3))
    got = _read(reader, kind, path)
    if kind == 'mesh':
        _assert_same_mesh(got, wrote)
    elif kind == 'match':
        for a, b in zip(got[:3], wrote[:3]):
            assert np.array_equal(a, b)
        assert got.strain == wrote.strain
    else:
        assert got.imgpaths == wrote.imgpaths and got.name == wrote.name
        assert np.array_equal(got.init_bboxes, wrote.init_bboxes)
        assert sorted(got.matches) == sorted(wrote.matches)
        for key, m in wrote.matches.items():
            for a, b in zip(got.matches[key][:3], m[:3]):
                assert np.array_equal(a, b)
        assert len(got.meshes) == len(wrote.meshes)
        for a, b in zip(got.meshes, wrote.meshes):
            _assert_same_mesh(a, b)


# ------------------------------- the device ------------------------------- #

def test_device_is_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.delenv(device_mod.DEVICE_ENV)
    for name in (None, 'cuda', 'cuda:0'):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            device_mod.get_device(name)
    assert device_mod.get_device('cpu') == torch.device('cpu')
    assert device_mod.get_device(torch.device('cpu')) == torch.device('cpu')
    monkeypatch.setenv(device_mod.DEVICE_ENV, 'cpu')
    assert device_mod.get_device() == torch.device('cpu')
    monkeypatch.setenv(device_mod.DEVICE_ENV, 'auto')
    with pytest.raises(RuntimeError):       # 'auto' is no device name
        device_mod.get_device()


def _entry_points(tmp_path):
    from feabas_tpu_torch.optimizer import SLM
    from feabas_tpu_torch.renderer import MeshRenderer
    from feabas_tpu_torch.ops import lradon
    from feabas_tpu_torch.scripts import (align_main, stitch_main,
                                          thumbnail_main)
    mesh = PMesh.from_bbox((0, 0, 100, 100), mesh_size=50)
    return {
        'stitch_main': lambda: stitch_main.main(['--mode', 'matching']),
        'align_main': lambda: align_main.main(['--mode', 'meshing']),
        'thumbnail_main': lambda: thumbnail_main.main(['--mode',
                                                       'downsample']),
        'detect_log_device': lambda: lradon.detect_log_device(
            np.zeros((32, 32), np.float32)),
        'Stitcher': lambda: pstitcher.Stitcher(['t.png'], [(0, 0, 10, 10)]),
        'Aligner': lambda: paligner.Aligner(str(tmp_path), str(tmp_path),
                                            str(tmp_path)),
        'Stack': lambda: paligner.Stack(section_list=[]),
        'MeshRenderer': lambda: MeshRenderer.from_mesh(mesh),
        'SLM': lambda: SLM([mesh]),
    }


@pytest.mark.parametrize('entry', ['stitch_main', 'align_main',
                                   'thumbnail_main', 'detect_log_device',
                                   'Stitcher', 'Aligner', 'Stack',
                                   'MeshRenderer', 'SLM'])
def test_entry_points_raise_without_a_card(entry, tmp_path, monkeypatch):
    """With no card and no FEABAS_TORCH_DEVICE every entry point of the
    port raises instead of running on the CPU; asked for the CPU, it
    runs."""
    cfg, _, _ = _stitch_workdir(str(tmp_path / 'proj'))
    monkeypatch.setenv('FEABAS_TPU_CONFIG_DIR', cfg)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    fn = _entry_points(tmp_path)[entry]
    monkeypatch.delenv(device_mod.DEVICE_ENV)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        fn()
    if entry not in ('stitch_main', 'align_main', 'thumbnail_main'):
        monkeypatch.setenv(device_mod.DEVICE_ENV, 'cpu')
        assert fn() is not None
