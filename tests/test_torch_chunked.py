"""The port's hierarchical chunked alignment (``Aligner._run_chunked``)
against the JAX package's, on the numpy-seeded stacks of
tests/test_aligner.py: the same residue rules, tforms within the port's
windowed-align parity bound, the same ``chunk_map.json``, byte-identical
chunk interiors after an append, and a stack started by the JAX package
and resumed by the port."""

import json
import os

import numpy as np
import pytest
import torch

from feabas_tpu import aligner as jaligner
from feabas_tpu import storage
from feabas_tpu.common import Match
from feabas_tpu.mesh import Mesh
from feabas_tpu_torch import aligner as paligner
from feabas_tpu_torch import config as pconfig
from feabas_tpu_torch.mesh import Mesh as PMesh
from feabas_tpu_torch.optimizer import Link as PLink

# the tier-1 run shares the cores among several pytest workers
torch.set_num_threads(1)

# port tforms against the JAX package's: the bound of the port's windowed
# align parity test (tests/test_torch_align.py, test_port_align_cli_matches_jax)
TFORM_PX = 0.1
SLIDE = {'window_size': 6, 'buffer_size': 2, 'start_loc': 'L',
         'residue_len': 3}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU, asked for by name; the port's config caches start and end
    empty."""
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


def _stack_on_disk(root, rng, S, start=0, mesh_size=40, n_pts=4,
                   drift_std=1.5):
    """Sections ``start`` .. ``start + S - 1`` of a stack of 120^2 cartesian
    meshes whose neighbour matches follow a seeded cumulative drift (the
    stacks of tests/test_aligner.py); the matches of an appended block
    start at its predecessor. Returns (mesh_dir, match_dir, names)."""
    mesh_dir = storage.join_paths(root, 'align', 'mesh')
    match_dir = storage.join_paths(root, 'align', 'matches')
    for d in (mesh_dir, match_dir):
        storage.makedirs(d)
    drift = np.cumsum(rng.normal(0, drift_std, (start + S, 2)), axis=0)
    drift -= drift[0]
    names = [f'sec{z:04d}' for z in range(start + S)]
    xs, ys = np.meshgrid(np.linspace(10, 110, n_pts),
                         np.linspace(10, 110, n_pts))
    pts = np.stack([xs.ravel(), ys.ravel()], -1)
    for z in range(start, start + S):
        Mesh.from_bbox((0, 0, 120, 120), cartesian=True, mesh_size=mesh_size,
                       name=names[z], resolution=4).save_to_h5(
            storage.join_paths(mesh_dir, names[z] + '.h5'))
    for z in range(max(start - 1, 0), start + S - 1):
        jaligner.save_matches_to_h5(storage.join_paths(
            match_dir, jaligner.match_name(names[z], names[z + 1])),
            Match(pts, pts + drift[z + 1] - drift[z], np.ones(len(pts)),
                  0.01), 4)
    return mesh_dir, match_dir, names


def _pair_residues(mesh_dir, tform_dir, match_dir, names):
    """Median link residue (px) of each neighbour pair at the port's tforms."""
    stack = paligner.Stack(section_list=names, mesh_dir=mesh_dir,
                           tform_dir=tform_dir, match_dir=match_dir,
                           resolution=4)
    meds = []
    for pair in stack.match_list:
        mt = stack.get_match(pair)
        link = PLink.from_coordinates(stack.get_mesh(pair[0]),
                                      stack.get_mesh(pair[1]), mt.xy0, mt.xy1,
                                      weight=mt.weight)
        meds.append(np.median(link.residues(gear='MOVING')))
    return np.asarray(meds)


def _tform_gap(tform_a, tform_b, names):
    """Largest MOVING-vertex distance (px) between two tform dirs."""
    return max(float(np.abs(
        PMesh.from_h5(os.path.join(tform_a, n + '.h5')).vertices_w_offset(
            'MOVING')
        - PMesh.from_h5(os.path.join(tform_b, n + '.h5')).vertices_w_offset(
            'MOVING')).max()) for n in names)


def _chunk_map(tform_dir, depth=1):
    path = os.path.join(os.path.dirname(tform_dir.rstrip('/')),
                        'chunked_tform', f'depth{depth}', 'chunk_map.json')
    with open(path) as f:
        return json.load(f)['chunks']


def _chunk_maps(tform_dir):
    """{path under chunked_tform: chunks} of every chunk map a run wrote
    (a meta level's maps nest under its parent's)."""
    root = os.path.join(os.path.dirname(tform_dir.rstrip('/')),
                        'chunked_tform')
    out = {}
    for d, _, files in os.walk(root):
        if 'chunk_map.json' in files:
            with open(os.path.join(d, 'chunk_map.json')) as f:
                out[os.path.relpath(d, root)] = json.load(f)['chunks']
    return out


def _snapshot(tform_dir):
    out = {}
    for n in sorted(os.listdir(tform_dir)):
        with open(os.path.join(tform_dir, n), 'rb') as f:
            out[n] = f.read()
    return out


def test_chunked_alignment_matches_jax(workdir):
    """tests/test_aligner.py::test_chunked_alignment (10 sections, depth 1,
    chunks of 4, junction 0.5) through both packages: every pair's median
    residue < 1 px in the port, port tforms within TFORM_PX of the JAX
    package's, and the same chunk map."""
    root = str(workdir)
    mesh_dir, match_dir, names = _stack_on_disk(
        root, np.random.default_rng(0), 10, mesh_size=30, n_pts=5,
        drift_std=2.0)
    chunk = {'chunked_to_depth': 1, 'default_chunk_size': 4,
             'junction_width': 0.5}
    slide = {'window_size': 4, 'buffer_size': 1, 'start_loc': 'L',
             'residue_len': 3}
    tj = os.path.join(root, 'jax', 'tform')
    tp = os.path.join(root, 'port', 'tform')
    jaligner.Aligner(mesh_dir, tj, match_dir, resolution=4).run(
        chunk_settings=dict(chunk), slide_window=dict(slide))
    paligner.Aligner(mesh_dir, tp, match_dir, resolution=4).run(
        chunk_settings=dict(chunk), slide_window=dict(slide))
    r = _pair_residues(mesh_dir, tp, match_dir, names)
    assert len(r) == len(names) - 1 and r.max() < 1.0, r
    assert _tform_gap(tp, tj, names) < TFORM_PX
    assert _chunk_map(tp) == _chunk_map(tj)
    assert all(c['committed'] for c in _chunk_map(tp))


def test_chunked_depth2_matches_windowed(workdir):
    """tests/test_aligner.py::test_chunked_depth2_matches_windowed in the
    port, cut from 64 sections in chunks of 4 to 16 in chunks of 2 (16 ->
    8 metas -> 4 metas -> one window: both recursion levels) to keep the
    file inside a minute on one core: the same residue rules against the
    port's windowed run, port tforms within TFORM_PX of the JAX package's
    depth-2 run, and the JAX package's chunk maps at depth 1 and 2."""
    root = str(workdir)
    mesh_dir, match_dir, names = _stack_on_disk(
        root, np.random.default_rng(1), 16)
    tw = os.path.join(root, 'align_w', 'tform')
    tc = os.path.join(root, 'align_c', 'tform')
    tj = os.path.join(root, 'align_j', 'tform')
    chunk = {'chunked_to_depth': 2, 'default_chunk_size': 2,
             'junction_width': 0.5}
    paligner.Aligner(mesh_dir, tw, match_dir, resolution=4).run(
        slide_window=dict(SLIDE))
    paligner.Aligner(mesh_dir, tc, match_dir, resolution=4).run(
        chunk_settings=dict(chunk), slide_window=dict(SLIDE))
    jaligner.Aligner(mesh_dir, tj, match_dir, resolution=4).run(
        chunk_settings=dict(chunk), slide_window=dict(SLIDE))
    assert len(_chunk_map(tc, depth=2)) == 8
    maps = _chunk_maps(tc)
    assert sorted(maps) == ['depth2', 'depth2/chunked_tform/depth1']
    assert maps == _chunk_maps(tj)
    assert _tform_gap(tc, tj, names) < TFORM_PX
    r_w = _pair_residues(mesh_dir, tw, match_dir, names)
    r_c = _pair_residues(mesh_dir, tc, match_dir, names)
    assert r_w.max() < 0.6, r_w.max()
    assert r_c.max() < max(2.5 * r_w.max(), 1.0), (r_c.max(), r_w.max())
    assert np.median(r_c) < max(3 * np.median(r_w), 0.5)


CHUNK = {'chunked_to_depth': 1, 'default_chunk_size': 8, 'junction_width': 1}


def test_persistent_chunk_map_incremental_growth(workdir):
    """tests/test_aligner.py::test_persistent_chunk_map_incremental_growth,
    cut from 48 + 16 sections to 24 + 8 (three chunks of 8, then one
    appended): the port writes the JAX package's chunk map before and after
    the append, and the append rewrites no interior section of the old
    chunks."""
    root = str(workdir)
    maps = {}
    for pkg, al in (('jax', jaligner.Aligner), ('port', paligner.Aligner)):
        sub = os.path.join(root, pkg)
        mesh_dir, match_dir, _ = _stack_on_disk(
            sub, np.random.default_rng(5), 24)
        tform = os.path.join(sub, 'align', 'tform')
        al(mesh_dir, tform, match_dir, resolution=4).run(
            chunk_settings=dict(CHUNK), slide_window=dict(SLIDE))
        before = _chunk_map(tform)
        snap0 = _snapshot(tform)
        _stack_on_disk(sub, np.random.default_rng(5), 8, start=24)
        storage.clear_exists_cache()
        al(mesh_dir, tform, match_dir, resolution=4).run(
            chunk_settings=dict(CHUNK), slide_window=dict(SLIDE))
        maps[pkg] = (before, _chunk_map(tform))
    before, after = maps['port']
    assert maps['port'] == maps['jax']
    assert len(before) == 3 and all(c['committed'] for c in before)
    assert len(after) == 4
    assert [c['sections'] for c in after[:3]] == [c['sections']
                                                  for c in before]
    snap1 = _snapshot(tform)
    assert len(snap0) == 24 and len(snap1) == 32
    changed = {n for n in snap0 if snap1[n] != snap0[n]}
    # only the junction tail of the last old chunk (junction_width 1, plus
    # its locked context section) may change
    assert changed <= {'sec0022.h5', 'sec0023.h5'}, changed


def test_port_resumes_a_stack_the_jax_package_chunked(workdir):
    """A stack of 16 sections chunked by the JAX package (depth 1, chunks
    of 8), 8 sections appended, resumed by the port: the port keeps the
    JAX package's chunk map and its chunk tforms, rewrites no interior
    section the JAX package committed, and writes every new tform."""
    root = str(workdir)
    mesh_dir, match_dir, _ = _stack_on_disk(root, np.random.default_rng(7),
                                            16)
    tform = os.path.join(root, 'align', 'tform')
    jaligner.Aligner(mesh_dir, tform, match_dir, resolution=4).run(
        chunk_settings=dict(CHUNK), slide_window=dict(SLIDE))
    before = _chunk_map(tform)
    chunk_dir = os.path.join(root, 'align', 'chunked_tform', 'depth1',
                             'chunk_tform')
    chunk0 = _snapshot(chunk_dir)
    snap0 = _snapshot(tform)
    _, _, names = _stack_on_disk(root, np.random.default_rng(7), 8, start=16)
    storage.clear_exists_cache()
    paligner.Aligner(mesh_dir, tform, match_dir, resolution=4).run(
        chunk_settings=dict(CHUNK), slide_window=dict(SLIDE))
    after = _chunk_map(tform)
    assert after[:2] == [dict(c) for c in before]
    assert len(after) == 3 and all(c['committed'] for c in after)
    assert all(_snapshot(chunk_dir)[n] == b for n, b in chunk0.items())
    snap1 = _snapshot(tform)
    assert sorted(snap1) == sorted(n + '.h5' for n in names)
    changed = {n for n in snap0 if snap1[n] != snap0[n]}
    assert changed <= {'sec0014.h5', 'sec0015.h5'}, changed
    r = _pair_residues(mesh_dir, tform, match_dir, names)
    assert r.max() < 1.0, r
