"""The port's Stitcher stages against the JAX package's: the affine
cascade after the translation stage (with and without tile groups), the
keywords the elastic stage hands on, and per-overlap error containment in
the match worker."""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

# the JAX package's storage imports h5py at load; on a host without it
# the port's standard-HDF5 subset stands in for it in this test process
try:
    import h5py  # noqa: F401
except ImportError:
    from feabas_tpu_torch import _h5lite
    sys.modules['h5py'] = _h5lite

from feabas_tpu import stitcher as jstitcher
from feabas_tpu.common import Match as JMatch
from feabas_tpu_torch import config as pconfig
from feabas_tpu_torch import constant as pconst
from feabas_tpu_torch import stitcher as pstitcher
from feabas_tpu_torch.common import Match as PMatch

from synthutil import tile_grid

# the tier-1 run shares the cores among several pytest workers
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU, asked for by name, and the solver in f64 as the JAX
    package's is in these tests; the port's config caches start and end
    empty."""
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    monkeypatch.setattr(pstitcher, 'SOLVER_DTYPE', torch.float64)
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


def _grid(seed=42):
    rng = np.random.default_rng(seed)
    return tile_grid(rng, rows=2, cols=2, tile_h=120, tile_w=150,
                     overlap=40, jitter=3.0)


def _stitchers(true_bboxes, stage_bboxes, groupings, bias=(0.0, 0.0)):
    """The same section in both packages: stage bboxes and matches from the
    true placement (4 x 4 points per overlap), those of tiles 2 and 3 off
    by ``bias`` px."""
    out = []
    for mod, match in ((jstitcher, JMatch), (pstitcher, PMatch)):
        st = mod.Stitcher([f't{i}.png' for i in range(4)], stage_bboxes)
        for i, j in ((0, 1), (2, 3), (0, 2), (1, 3)):
            ovl = (max(true_bboxes[i][0], true_bboxes[j][0]),
                   max(true_bboxes[i][1], true_bboxes[j][1]),
                   min(true_bboxes[i][2], true_bboxes[j][2]),
                   min(true_bboxes[i][3], true_bboxes[j][3]))
            gx, gy = np.meshgrid(np.linspace(ovl[0] + 3, ovl[2] - 3, 4),
                                 np.linspace(ovl[1] + 3, ovl[3] - 3, 4))
            w_pts = np.stack([gx.ravel(), gy.ravel()], -1)
            st.matches[(i, j)] = match(w_pts - true_bboxes[i][:2],
                                       w_pts - true_bboxes[j][:2]
                                       + (bias if (i, j) == (2, 3) else 0),
                                       np.ones(len(w_pts)), 0.01)
        if groupings is not None:
            st.set_groupings(np.asarray(groupings))
        st.initialize_meshes(mesh_sizes=[50, 100])
        st.initialize_optimizer()
        out.append(st)
    return out


def _placements(st, gear):
    return [m.vertices_w_offset(gear) for m in st.meshes]


@pytest.mark.parametrize('groupings', [None, [0, 0, 1, 1]])
def test_affine_stage_starts_from_the_translation_stage(workdir, groupings):
    """Translation then affine, as the stitch driver runs them, with the
    matches of tiles 2 and 3 off by (1.5, -1) px: the port places every
    vertex as the JAX package does (f64 both, 1e-6 px). With groups, one
    affine moves each group from where the translation stage put its
    tiles: a group's placement is one affine of its translation-stage
    placement, not of its stage placement."""
    _, _, true_bboxes, stage_bboxes = _grid()
    jst, pst = _stitchers(true_bboxes, stage_bboxes, groupings,
                          bias=np.array([1.5, -1.0]))
    moving = pconst.MESH_GEAR_MOVING
    for st in (jst, pst):
        st.optimize_translation()
    after_translation = _placements(pst, moving)
    for st in (jst, pst):
        st.optimize_affine(use_group=True)
    want = _placements(jst, moving)
    got = _placements(pst, moving)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() < 1e-6
    if groupings is None:
        return
    stage = _placements(pst, pconst.MESH_GEAR_FIXED)
    for members in ((0, 1), (2, 3)):
        dst = np.concatenate([got[i] for i in members])
        # one affine of the group's translation-stage vertices gives its
        # placement; one of its stage vertices does not
        assert _affine_residual(np.concatenate(
            [after_translation[i] for i in members]), dst) < 1e-6
        assert _affine_residual(np.concatenate(
            [stage[i] for i in members]), dst) > 0.1


def _affine_residual(src, dst):
    """Largest residual of the least-squares affine src -> dst."""
    A = np.concatenate([src, np.ones((len(src), 1))], 1)
    T = np.linalg.lstsq(A, dst, rcond=None)[0]
    return float(np.abs(A @ T - dst).max())


def test_elastic_stage_hands_on_groupings_and_chances(workdir, monkeypatch):
    """``chances`` and, with ``use_groupings``, the groupings in the SLM's
    mesh order reach ``SLM.optimize_elastic`` in both packages; after the
    translation stage, with the matches of tiles 2 and 3 off by (1.5, -1)
    px, the grouped solve places every vertex as the JAX package does (f64
    both, 1e-6 px), each group's tiles moved alike."""
    _, _, true_bboxes, stage_bboxes = _grid()
    jst, pst = _stitchers(true_bboxes, stage_bboxes, [0, 0, 1, 1],
                          bias=np.array([1.5, -1.0]))
    seen = {}
    for name, st in (('jax', jst), ('port', pst)):
        slm = st._slm

        def spy(name=name, **kw):
            seen[name] = kw
            return 0.0, 0.0
        monkeypatch.setattr(slm, 'optimize_elastic', spy)
        st.optimize_elastic(chances=20, use_groupings=True, tol=1e-5,
                            unknown=1)
    assert set(seen['jax']) == set(seen['port'])
    assert seen['port']['chances'] == 20 and 'unknown' not in seen['port']
    assert np.array_equal(seen['port']['groupings'], [0, 0, 1, 1])
    assert np.array_equal(seen['jax']['groupings'], seen['port']['groupings'])
    monkeypatch.undo()
    monkeypatch.setattr(pstitcher, 'SOLVER_DTYPE', torch.float64)
    moving = pconst.MESH_GEAR_MOVING
    costs = []
    for st in (jst, pst):
        st.optimize_translation()
        after_translation = _placements(st, moving)
        costs.append(st.optimize_elastic(use_groupings=True, tol=1e-10))
    assert np.allclose(costs[1], costs[0], rtol=1e-8)
    for g, w in zip(_placements(pst, moving), _placements(jst, moving)):
        assert np.abs(g - w).max() < 1e-6
    du = [m - t for m, t in zip(_placements(pst, moving), after_translation)]
    assert max(np.abs(d).max() for d in du) > 1e-3
    for a, b in ((0, 1), (2, 3)):
        assert np.abs(du[a] - du[b]).max() < 1e-9


class _RaisingLoader:
    """Mixin: a crop of ``bad_id`` raises TypeError once ``armed``."""
    bad_id = 3
    armed = False

    def crop(self, bbox, **kwargs):
        if self.armed and kwargs.get('fileid') == self.bad_id:
            raise TypeError('unreadable tile')
        return super().crop(bbox, **kwargs)


def _tiles_on_disk(root):
    _, tiles, _, stage_bboxes = _grid(seed=7)
    paths = []
    for i, t in enumerate(tiles):
        p = os.path.join(root, f't{i}.png')
        cv2.imwrite(p, t)
        paths.append(p)
    return paths, stage_bboxes


@pytest.mark.parametrize('fault', ['truncated_png', 'crop_raises',
                                   'photometric_raises'])
def test_one_unreadable_tile_fails_only_its_overlaps(workdir, tmp_path,
                                                     monkeypatch, fault):
    """Tile 3 unreadable (a truncated PNG), or its loader raising TypeError
    before the batched match or after it (the photometrics): the overlaps
    of tile 3 get an error and every other overlap is matched, in both
    packages alike."""
    from feabas_tpu import dal as jdal
    from feabas_tpu import matcher as jmatcher
    from feabas_tpu_torch import dal as pdal
    from feabas_tpu_torch import matcher as pmatcher
    paths, stage_bboxes = _tiles_on_disk(str(tmp_path))
    if fault == 'truncated_png':
        with open(paths[3], 'rb') as f:
            head = f.read(200)
        with open(paths[3], 'wb') as f:
            f.write(head)
    overlaps = [(0, 1), (2, 3), (0, 2), (1, 3)]
    config = {'compute_photometric': fault == 'photometric_raises'}
    results = {}
    for name, dal, mod, matcher in (
            ('jax', jdal, jstitcher, jmatcher),
            ('port', pdal, pstitcher, pmatcher)):
        loader = type('Loader', (_RaisingLoader, dal.StaticImageLoader), {})(
            paths, stage_bboxes)
        loader.armed = fault == 'crop_raises'
        batched = matcher.match_pairs_batched

        def arm_then_match(jobs, *a, loader=loader, batched=batched, **k):
            if fault == 'photometric_raises':
                loader.armed = True
            return batched(jobs, *a, **k)
        monkeypatch.setattr(matcher, 'match_pairs_batched', arm_then_match)
        results[name] = {tuple(key): (match, err) for key, match, _, err in
                         mod.subprocess_match_list_of_overlaps(
                             loader, overlaps, 20, config)}
    for name, res in results.items():
        assert set(res) == set(overlaps), name
        for key, (match, err) in res.items():
            if 3 in key:
                assert match is None and err is not None, (name, key)
            else:
                assert err is None and match is not None, (name, key, err)
                assert len(match.xy0) > 0
    for key in overlaps:
        jerr, perr = results['jax'][key][1], results['port'][key][1]
        assert (jerr is None) == (perr is None)
        if perr is not None:
            assert perr.split(':')[0] == jerr.split(':')[0]


def _renderers(root, names, bboxes):
    """A ``MontageRenderer`` of each package over the same tiles on disk."""
    out = []
    for mod in (jstitcher, pstitcher):
        st = mod.Stitcher(names, bboxes, root_dir=root, name='s')
        st.initialize_meshes()
        out.append(mod.MontageRenderer.from_stitcher(
            st, loader_config={'apply_CLAHE': False, 'inverse': False}))
    return out


@pytest.mark.parametrize('lut_type', ['BRIGHTNESS_CONTRAST_ADJUST',
                                      'INTERP1D'])
def test_add_transfer_functions_matches_jax(workdir, tmp_path, lut_type):
    """tests/test_dal_renderer.py::test_montage_add_transfer_functions in
    both packages, with either LUT type: the same (gain, offset) per tile,
    the same render within 1 LSB, and tile B's halved brightness restored
    in the port's render."""
    rng = np.random.default_rng(11)
    base = (rng.random((100, 100)) * 100 + 50).astype(np.uint8)
    cv2.imwrite(str(tmp_path / 'a.png'), base)
    cv2.imwrite(str(tmp_path / 'b.png'), (base // 2).astype(np.uint8))
    jmr, pmr = _renderers(str(tmp_path), ['a.png', 'b.png'],
                          [(0, 0, 100, 100), (100, 0, 200, 100)])
    # gain 2 restores tile B (as a line through three control points)
    lut = ({'__TYPE__': lut_type, 'b.png': [0.0, 2.0]}
           if lut_type == 'BRIGHTNESS_CONTRAST_ADJUST' else
           {'__TYPE__': lut_type, 'b.png': [[0, 60, 120], [0, 120, 240]]})
    tj = jmr.add_transfer_functions(lut)
    tp = pmr.add_transfer_functions(lut)
    np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tp, [[1.0, 0.0], [2.0, 0.0]], atol=1e-9)
    oj = jmr.crop((0, 0, 200, 100)).astype(int)
    op = pmr.crop((0, 0, 200, 100)).astype(int)
    assert np.abs(op - oj).max() <= 1
    assert abs(float(op[:, :100].mean()) - float(base.mean())) < 2.0
    assert abs(float(op[:, 100:].mean()) - float(base.mean())) < 3.0


def test_generate_roi_mask_matches_jax(workdir, tmp_path):
    """tests/test_stitcher_stages.py::test_generate_roi_mask in both
    packages: equal masks, and the reference test's own checks on the
    port's."""
    img = (np.random.default_rng(3).random((160, 160)) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / 'a.png'), img)
    cv2.imwrite(str(tmp_path / 'b.png'), img)
    jmr, pmr = _renderers(str(tmp_path), ['a.png', 'b.png'],
                          [(0, 0, 160, 160), (120, 0, 280, 160)])
    for scale in (0.5, 1.0 / 16):
        mj = jmr.generate_roi_mask(scale=scale)
        mp = pmr.generate_roi_mask(scale=scale)
        assert mp.dtype == np.uint8 and np.array_equal(mp, mj), scale
    mask = pmr.generate_roi_mask(scale=0.5)
    assert mask.shape == (80, 140)
    assert mask[40, 20] == 255 and mask[40, 120] == 255
    assert (mask[2:-2, 2:-2] > 0).mean() > 0.95
    # a canvas whose corner is no whole pixel at the scale (the stitch
    # CLI's canvas starts at (1, 1)): the JAX package's grid outgrows its
    # mask there; the port's starts at the floor of the corner
    box = (1, 1, 281, 161)
    with pytest.raises(ValueError):
        jmr.generate_roi_mask(scale=1 / 16, canvas_bbox=box)
    mask = pmr.generate_roi_mask(scale=1 / 16, canvas_bbox=box)
    assert mask.shape == (10, 18) and (mask[:, :17] == 255).all()


@pytest.mark.parametrize('store', ['tensorstore', '_tslite'])
def test_render_to_tensorstore_matches_jax(workdir, tmp_path, monkeypatch,
                                           store):
    """tests/test_stitcher_stages.py::test_stitch_render_to_tensorstore in
    both packages, the port on either store it binds: the same chunks
    written, the volume within 1 LSB of the JAX package's, and the
    reference test's own check on the port's."""
    import tensorstore as ts
    from feabas_tpu_torch import _tslite
    from feabas_tpu_torch import dal as pdal
    from synthutil import texture
    monkeypatch.setattr(pdal, 'ts', ts if store == 'tensorstore' else _tslite)
    world = texture(np.random.default_rng(42), 120, 200)
    p0, p1 = str(tmp_path / 'x.png'), str(tmp_path / 'y.png')
    cv2.imwrite(p0, world[:, :120])
    cv2.imwrite(p1, world[:, 80:])
    vols, counts = {}, {}
    for name, mod in (('jax', jstitcher), ('port', pstitcher)):
        st = mod.Stitcher([p0, p1], [(0, 0, 120, 120), (80, 0, 200, 120)])
        st.initialize_meshes(mesh_sizes=[60])
        for m, bb in zip(st.meshes, st.init_bboxes):
            m.set_translation((bb[0], bb[1]), gear=('INITIAL', 'MOVING'))
        vols[name] = str(tmp_path / f'{name}_sec')
        counts[name] = mod.MontageRenderer.from_stitcher(st) \
            .render_series_to_tensorstore(vols[name],
                                          driver='neuroglancer_precomputed',
                                          read_chunk_size=(64, 64))
    assert counts['port'] == counts['jax'] > 0
    got, want = [ts.open({'driver': 'neuroglancer_precomputed', 'kvstore': {
        'driver': 'file', 'path': vols[k]}}).result().read().result()
        for k in ('port', 'jax')]
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    blk = np.swapaxes(got[20:100, 20:100, 0, 0], 0, 1)
    cc = np.corrcoef(blk.astype(float).ravel(),
                     world[20:100, 20:100].astype(float).ravel())[0, 1]
    assert cc > 0.98, cc
