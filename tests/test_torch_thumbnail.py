"""The port's thumbnail slice against the JAX package: config accessors,
the keypoint containers and match filters on the same keypoints (carried
across by ``state``), the subpixel fit, the pair matcher and the two align
modes on the same images, the thumbnail and mask writers, and the whole
thumbnail CLI on copies of one work dir."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from feabas_tpu import config as jconfig
from feabas_tpu import mipmap as jmipmap
from feabas_tpu import thumbnail as jthumb
from feabas_tpu_torch import config as pconfig
from feabas_tpu_torch import mipmap as pmipmap
from feabas_tpu_torch import state
from feabas_tpu_torch import thumbnail as pthumb
from synthutil import texture

# the tier-1 run shares the cores among several pytest workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU, asked for by name; the port's config caches start and end
    empty."""
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


def _p(kp):
    """The port's copy of a JAX KeyPoints."""
    return state.keypoints_from_arrays(kp.xy, kp.response, kp.class_id, kp.des)


def _shifted_pair(seed, n, t):
    """Two views of one texture: the content at p in img1 sits at p + t in
    img0."""
    import cv2
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    w = gaussian_filter(rng.normal(0, 1, (n + 64, n + 64)), 3)
    world = (w / w.std() * 40 + 128).clip(0, 255).astype(np.float32)
    M = np.float32([[1, 0, -t[0]], [0, 1, -t[1]]])
    img1 = cv2.warpAffine(world, M, world.shape[::-1],
                          flags=cv2.INTER_LINEAR)[32:32 + n, 32:32 + n]
    return world[32:32 + n, 32:32 + n], img1


# ------------------------------- config ------------------------------- #

def test_thumbnail_config_accessors_match_jax(workdir):
    from feabas_tpu import storage
    storage.save_yaml(os.path.join(str(workdir), 'configs',
                                   'thumbnail_configs.yaml'),
                      {'downsample': {'thumbnail_mip_level': 3},
                       'alignment': {'compare_distance': 3}})
    jconfig.clear_config_caches()
    pconfig.clear_config_caches()
    conf = pconfig.thumbnail_configs()
    assert conf == jconfig.thumbnail_configs()
    assert conf['alignment']['compare_distance'] == 3
    assert conf['alignment']['feature_matching']['detect_settings'] == \
        {'sigma': 3.5, 'min_spacing': 10, 'num_features': 5000}
    assert pconfig.thumbnail_resolution() == jconfig.thumbnail_resolution() \
        == 32.0


# ------------------------ containers and filters ------------------------ #

def test_keypoints_carried_across_by_state(rng):
    kj = jthumb.KeyPoints(rng.uniform(0, 100, (10, 2)), rng.random(10),
                          np.arange(10) % 3)
    kj.des = rng.random((10, 6, 8)).astype(np.float32)
    kp = _p(kj)
    assert isinstance(kp, pthumb.KeyPoints) and kp.num_points == 10
    for name in ('xy', 'response', 'class_id', 'des'):
        assert np.array_equal(getattr(kp, name), getattr(kj, name)), name
    kp.xy[0] += 1.0                        # the port's copy owns its arrays
    assert not np.array_equal(kp.xy, kj.xy)
    sub = kp.filter_by_mask(np.arange(10) < 4)
    assert sub.num_points == 4 and sub.des.shape == (4, 6, 8)
    assert sub.des_dev is None
    bare = state.keypoints_from_arrays(kj.xy)
    assert bare.des is None and (bare.class_id == 0).all()


def test_keypoint_matches_container(rng):
    kp0 = pthumb.KeyPoints(rng.uniform(0, 100, (10, 2)),
                           class_id=np.arange(10) % 2)
    kp1 = pthumb.KeyPoints(rng.uniform(0, 100, (12, 2)),
                           class_id=np.arange(12) % 3)
    km = pthumb.KeyPointMatches.from_keypoints(kp0, kp1, [0, 2, 4], [1, 3, 5],
                                               conf=[0.9, 0.8, 0.7])
    assert km.num_points == 3
    assert np.array_equal(km.class_id0, [0, 0, 0])
    assert np.array_equal(km.class_id1, [1, 0, 2])
    km2 = km.filter_match(np.array([True, False, True]), inplace=False)
    assert km2.num_points == 2 and km.num_points == 3
    m = km2.to_match()
    assert m.xy0.shape == (2, 2) and m.weight.shape == (2,)
    assert type(m).__module__ == 'feabas_tpu_torch.common'


def _noisy_matches(rng, n=80, n_bad=14):
    xy1 = rng.uniform(0, 300, (n, 2))
    T = np.eye(3)
    T[:2, :2] = [[0.98, 0.05], [-0.05, 1.01]]
    T[2, :2] = [10, -4]
    xy0 = np.c_[xy1, np.ones(n)] @ T
    xy0 = xy0[:, :2] + rng.normal(0, 0.3, (n, 2))
    xy0[:n_bad] += rng.uniform(20, 60, (n_bad, 2))
    return xy0, xy1, rng.uniform(0.3, 1.0, n)


def test_filters_draw_the_same_samples_as_jax(rng):
    """The three host filters use ``default_rng(0)`` in both packages: equal
    masks, transforms and groups on the same matches."""
    xy0, xy1, conf = _noisy_matches(rng)
    keep_j = jthumb.filter_match_pairwise_strain(xy0, xy1, conf,
                                                 strain_limit=0.1)
    keep_p = pthumb.filter_match_pairwise_strain(xy0, xy1, conf,
                                                 strain_limit=0.1)
    assert np.array_equal(keep_p, keep_j) and keep_p[14:].mean() > 0.9
    for c in (None, conf):
        mj, Tj = jthumb.filter_match_global_ransac(xy0, xy1, c, dis_tol=3)
        mp, Tp = pthumb.filter_match_global_ransac(xy0, xy1, c, dis_tol=3)
        assert np.array_equal(mp, mj) and np.array_equal(Tp, Tj)
        assert mp[14:].all() and not mp[:14].any()
    # two affine models, class-pure groups
    xyb1 = rng.uniform(350, 450, (60, 2))
    a0 = np.concatenate([xy0[14:], xyb1 + [-20, 14]])
    a1 = np.concatenate([xy1[14:], xyb1])
    cls = np.r_[np.ones(66, np.int32), np.full(60, 2, np.int32)]
    gj = jthumb.filter_match_sequential_ransac(a0, a1, None, class0=cls,
                                               class1=cls, dis_tol=1.5)
    gp = pthumb.filter_match_sequential_ransac(a0, a1, None, class0=cls,
                                               class1=cls, dis_tol=1.5)
    assert len(gp) == len(gj) >= 2
    for a, b in zip(gp, gj):
        assert np.array_equal(a, b)
        assert (a < 66).all() or (a >= 66).all()
    assert gp[0].size > 45 and gp[1].size > 45


def test_verify_match_elastic_matches_jax(rng):
    """The elastic verification (two-mesh SLM, fused ENG solve with
    negative lambdas) keeps the same candidates."""
    pts = rng.uniform(20, 180, (40, 2))
    settled = (pts + [5.0, 3.0], pts, np.ones(40))
    cand1 = rng.uniform(30, 170, (12, 2))
    cand0 = cand1 + [5.0, 3.0]
    cand0[:4] += [25.0, -20.0]
    args = (cand0, cand1, np.ones(12), settled, (200, 200), (200, 200))
    keep_j = jthumb.verify_match_elastic(*args, dis_tol=6.0)
    keep_p = pthumb.verify_match_elastic(*args, dis_tol=6.0)
    assert np.array_equal(keep_p, keep_j)
    assert keep_p[4:].mean() > 0.8 and not keep_p[:4].any()


# --------------------------- features, subpixel --------------------------- #

def test_no_keypoints_give_no_descriptors(rng):
    img = texture(rng, 200, 200, blur=3)
    empty = pthumb.extract_LRadon_feature(img, pthumb.KeyPoints(np.zeros((0, 2))))
    assert empty.des.shape == (0, 6, 8)


def test_refine_matches_subpixel_equals_jax():
    t = np.array([17.3, -9.6])
    img0, img1 = _shifted_pair(6, 384, t)
    rng = np.random.default_rng(6)
    xs, ys = np.meshgrid(np.linspace(60, 320, 5), np.linspace(60.5, 320, 5))
    xy1 = np.stack([xs.ravel(), ys.ravel()], -1)
    xy0 = xy1 + t + rng.normal(0, 1.5, xy1.shape)
    want = jthumb.refine_matches_subpixel(img0, img1, xy0, xy1, sigma=3.5)
    got = pthumb.refine_matches_subpixel(img0, img1, xy0, xy1, sigma=3.5)
    assert np.array_equal(got, want)
    assert np.median(np.linalg.norm(got - (xy1 + t), axis=-1)) < 0.08


# --------------------------- the pair matchers --------------------------- #

def test_match_two_thumbnails_with_carried_keypoints_matches_jax(workdir):
    """The same keypoints (the JAX package's, carried across by state) go
    through both robustness loops: the same matches to 1e-4 px."""
    t = np.array([9.4, -5.2])
    img0, img1 = _shifted_pair(13, 384, t)
    s = {'detect_settings': {'min_spacing': 12}, 'max_rounds': 2}
    kj0 = jthumb.prepare_image(img0, **s)
    kj1 = jthumb.prepare_image(img1, **s)
    kj0.des_dev = kj1.des_dev = None
    mj = jthumb.match_two_thumbnails_LRadon(img0, img1, kps0=kj0, kps1=kj1,
                                            **s)
    mp = pthumb.match_two_thumbnails_LRadon(img0, img1, kps0=_p(kj0),
                                            kps1=_p(kj1), **s)
    assert mp.xy0.shape == mj.xy0.shape and mp.xy0.shape[0] >= 8
    assert np.abs(mp.xy0 - mj.xy0).max() < 1e-4
    assert np.array_equal(mp.xy1, mj.xy1)
    assert np.abs(mp.weight - mj.weight).max() < 1e-5
    err = np.linalg.norm((mp.xy0 - mp.xy1) - t, axis=-1)
    assert np.median(err) < 1.0


def test_match_two_thumbnails_device_route_matches_jax(workdir):
    """From the images alone (pair features on the device, masked
    re-matching on the resident descriptors): the known motion within the
    JAX test's bound, the median displacement within 0.1 px of JAX's, and
    the same result from prepared keypoints."""
    t = np.array([11.0, -7.5])
    img0, img1 = _shifted_pair(47, 384, t)
    s = {'detect_settings': {'min_spacing': 12}, 'max_rounds': 2}
    # the JAX package takes its device route by its use_device flags
    js = {'detect_settings': {'min_spacing': 12, 'use_device': True},
          'extract_settings': {'use_device': True}, 'max_rounds': 2}
    mj = jthumb.match_two_thumbnails_LRadon(img0, img1, **js)
    mp = pthumb.match_two_thumbnails_LRadon(img0, img1, **s)
    assert mp is not None and abs(mp.xy0.shape[0] - mj.xy0.shape[0]) <= 2
    dj = np.median(mj.xy0 - mj.xy1, axis=0)
    dp = np.median(mp.xy0 - mp.xy1, axis=0)
    assert np.abs(dp - dj).max() < 0.1
    assert np.median(np.linalg.norm((mp.xy0 - mp.xy1) - t, axis=-1)) < 1.0
    kp0 = pthumb.prepare_image(img0, **s)
    kp1 = pthumb.prepare_image(img1, **s)
    staged = pthumb.match_two_thumbnails_LRadon(img0, img1, kps0=kp0,
                                                kps1=kp1, **s)
    assert np.allclose(np.sort(staged.xy0, axis=0), np.sort(mp.xy0, axis=0),
                       atol=1e-5)


def test_match_two_thumbnails_rotation_and_pieces(rng, workdir):
    """A 30 degree turn, and a section in two pieces that moved apart with
    region labels: the bounds of the JAX package's own tests."""
    import cv2
    img0 = texture(rng, 260, 260, blur=3)
    M = cv2.getRotationMatrix2D((130, 130), 30, 1.0)
    img1 = cv2.warpAffine(img0, M, (260, 260), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REFLECT)
    m = pthumb.match_two_thumbnails_LRadon(img0, img1)
    assert m is not None and m.xy0.shape[0] >= 8
    Ainv = np.linalg.inv(np.vstack([M, [0, 0, 1]]))
    want = (np.c_[m.xy1, np.ones(len(m.xy1))] @ Ainv.T)[:, :2]
    assert np.median(np.linalg.norm(m.xy0 - want, axis=-1)) < 2.0
    h, w = 200, 420
    a = texture(rng, h, w).astype(np.float32)
    b = np.zeros_like(a)
    b[:, :200] = np.roll(np.roll(a[:, :200], 4, axis=0), 7, axis=1)
    b[:, 210:] = np.roll(np.roll(a, 9, axis=0), -6, axis=1)[:, 210:]
    mask = np.zeros((h, w), np.uint8)
    mask[:, :200] = 1
    mask[:, 210:] = 2
    m = pthumb.match_two_thumbnails_LRadon(a, b, mask0=mask, mask1=mask)
    d = m.xy1 - m.xy0
    left, right = m.xy1[:, 0] < 200, m.xy1[:, 0] >= 210
    assert left.sum() >= 5 and right.sum() >= 5
    assert (np.median(np.abs(d[left] - [7, 4]), axis=0) < 1.5).all()
    assert (np.median(np.abs(d[right] - [-6, 9]), axis=0) < 1.5).all()


@pytest.mark.parametrize('deg,resolved', [(30, True), (15, False),
                                          (90, False)])
def test_rotation_limits_equal_the_jax_packages(workdir, deg, resolved):
    """What the feature stage resolves, in both packages alike: a turn by
    one variant step (30 degrees) matches; halfway between two variants
    the descriptors find no consistent set; beyond the strain filter's
    shear_limit of 45 degrees every pair is rejected, whatever variant
    won."""
    import cv2
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(1)
    n = 384
    w = gaussian_filter(rng.normal(0, 1, (n + 300, n + 300)), 4)
    world = (w / w.std() * 40 + 128).clip(0, 255).astype(np.uint8)
    c = (world.shape[1] - 1) / 2
    M = cv2.getRotationMatrix2D((c, c), deg, 1.0)
    img0 = world[150:150 + n, 150:150 + n]
    img1 = cv2.warpAffine(world, M, world.shape[::-1],
                          flags=cv2.INTER_LINEAR)[150:150 + n, 150:150 + n]
    mj = jthumb.match_two_thumbnails_LRadon(img0, img1)
    mp = pthumb.match_two_thumbnails_LRadon(img0, img1)
    assert (mj is not None) == (mp is not None) == resolved
    if resolved:
        assert mp.xy0.shape == mj.xy0.shape and mp.xy0.shape[0] >= 8
        # the content at p1 of img1 sits at c + R(deg) (p1 - c) in img0
        a = np.deg2rad(deg)
        R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        ci = c - 150
        want = (mp.xy1 - ci) @ R.T + ci
        assert np.median(np.linalg.norm(mp.xy0 - want, axis=-1)) < 1.0


def test_linkless_solve_keeps_positions_as_jax_does():
    """Sections whose every pair failed to match reach the window solve
    with no link: positions stay, in both packages; a strained mesh with
    no link relaxes as the JAX one does (f64 both, 1e-6 px)."""
    from feabas_tpu import optimizer as jopt
    from feabas_tpu.mesh import Mesh
    from feabas_tpu_torch import optimizer as popt
    m = Mesh.from_bbox((0, 0, 100, 100), mesh_size=30, uid=0)
    m.set_translation(np.array([3.0, -2.0]))
    for opt, mesh in ((jopt, m),
                      (popt, state.mesh_from_init_dict(m.get_init_dict()))):
        before = mesh.vertices_w_offset('MOVING').copy()
        slm = opt.SLM([mesh])
        assert slm.optimize_linear(stiffness_lambda=-1.0,
                                   crosslink_lambda=-1.0) == (0.0, 0.0)
        assert np.abs(mesh.vertices_w_offset('MOVING') - before).max() < 1e-6
    v = m.vertices('MOVING')
    m.set_vertices(v * [1.1, 1.0], 'MOVING', offset=m.offset('MOVING'))
    strained = state.mesh_from_init_dict(m.get_init_dict())
    costs = [jopt.SLM([m]).optimize_linear(stiffness_lambda=-1.0,
                                           crosslink_lambda=-1.0, tol=1e-10),
             popt.SLM([strained], dtype=torch.float64).optimize_linear(
                 stiffness_lambda=-1.0, crosslink_lambda=-1.0, tol=1e-10)]
    assert costs[0] == costs[1]
    got, want = (x.vertices_w_offset('MOVING') for x in (strained, m))
    assert np.abs(got - want).max() < 1e-6
    assert np.abs(got - v * [1.1, 1.0] - m.offset('INITIAL')).max() > 1.0


@pytest.mark.parametrize('mode,shift', [('feature', (6, 9)),
                                        ('template', (-4, 11))])
def test_align_two_thumbnails_matches_jax(rng, workdir, mode, shift):
    """Feature (or template) stage plus PMCC refinement: the known shift
    within the JAX tests' 0.5 px, and within 0.1 px of the JAX package's
    median displacement."""
    n = 240 if mode == 'feature' else 200
    img0 = texture(rng, n, n, blur=2)
    img1 = np.roll(img0, shift, axis=(0, 1))
    kw = dict(match_mode=mode, block_matching={'spacings': [60, 30],
                                               'conf_thresh': 0.25})
    mj = jthumb.align_two_thumbnails(img0, img1, **kw)
    mp, coarse = pthumb.align_two_thumbnails(img0, img1, return_coarse=True,
                                             **kw)
    assert mp is not None and mp.xy0.shape[0] >= 6 and coarse is not None
    dp = np.median(mp.xy0 - mp.xy1, axis=0)
    assert np.allclose(dp, [-shift[1], -shift[0]], atol=0.5)
    assert np.abs(dp - np.median(mj.xy0 - mj.xy1, axis=0)).max() < 0.1


def test_align_two_thumbnails_returns_none_without_a_coarse_match(rng,
                                                                  workdir):
    flat = np.full((128, 128), 128.0, np.float32)
    assert pthumb.align_two_thumbnails(flat, flat) is None
    assert pthumb.align_two_thumbnails(flat, flat, return_coarse=True) \
        == (None, None)


# --------------------- no CPU default outside get_device -------------------- #

def _device_entries(rng):
    from feabas_tpu_torch.ops import lradon
    img = texture(rng, 96, 96, blur=3)
    kp = pthumb.KeyPoints(rng.uniform(20, 70, (12, 2)))
    kp.des = rng.normal(size=(12, 6, 8)).astype(np.float32)
    return {
        'features_device': lambda d: lradon.features_device(img, device=d),
        'pair_features_device': lambda d: lradon.pair_features_device(
            img, img, device=d),
        'lradon_descriptors_device': lambda d:
            lradon.lradon_descriptors_device(img, kp.xy, device=d),
        'match_LRadon_feature': lambda d: pthumb.match_LRadon_feature(
            kp, kp, device=d),
        'prepare_image': lambda d: pthumb.prepare_image(img, device=d),
        'align_template': lambda d: pthumb.align_two_thumbnails(
            img, img, match_mode='template', return_coarse=True, device=d),
        'generate_thumbnail_mask': lambda d: pmipmap.generate_thumbnail_mask(
            '/nonexistent/tform.h5', '/nonexistent/mask.png', device=d),
    }


@pytest.mark.parametrize('entry', [
    'features_device', 'pair_features_device', 'lradon_descriptors_device',
    'match_LRadon_feature', 'prepare_image', 'align_template',
    'generate_thumbnail_mask'])
def test_device_none_means_the_card(entry, rng, workdir, monkeypatch):
    """Every device entry point this slice adds resolves ``device=None``
    through ``get_device``: an error where there is no card, the CPU only
    when asked for by name or through FEABAS_TORCH_DEVICE."""
    fn = _device_entries(rng)[entry]
    if entry != 'generate_thumbnail_mask':
        assert fn('cpu') is not None                  # asked for by name
        assert fn(None) is not None                   # asked for by the env
    monkeypatch.delenv('FEABAS_TORCH_DEVICE')
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        fn(None)


def test_no_new_module_names_the_cpu_as_a_default():
    pkg = os.path.join(REPO, 'feabas_tpu_torch')
    for rel in ('thumbnail.py', 'mipmap.py', 'ops/lradon.py',
                'scripts/thumbnail_main.py'):
        with open(os.path.join(pkg, rel)) as f:
            src = f.read()
        assert "device('cpu')" not in src and "device='cpu'" not in src, rel
        assert 'get_device' in src, rel


# -------------------------- thumbnails and masks -------------------------- #

def _one_section(root, img, name='s0'):
    from feabas_tpu import storage
    from feabas_tpu.common import imwrite
    d = os.path.join(root, name)
    imwrite(os.path.join(d, name + '_tr1-tc1.png'), img)
    meta = os.path.join(d, 'metadata.txt')
    with storage.File(meta, 'w') as f:
        f.write('{ROOT_DIR}\t' + d + '\n{RESOLUTION}\t4\n'
                f'{name}_tr1-tc1.png\t0\t0\t{img.shape[1]}\t{img.shape[0]}\n')
    return meta


@pytest.mark.parametrize('highpass', [False, True])
def test_create_thumbnail_equals_jax(rng, tmp_path, highpass):
    img = texture(rng, 512, 640, blur=3)
    meta = _one_section(str(tmp_path), img)
    kw = dict(thumbnail_mip=3, src_mip=0, highpass=highpass,
              highpass_inter_mip=1)
    out_j = jmipmap.create_thumbnail(meta, str(tmp_path / 'j.png'), **kw)
    out_p = pmipmap.create_thumbnail(meta, str(tmp_path / 'p.png'), **kw)
    from feabas_tpu.common import imread
    a, b = imread(out_p), imread(out_j)
    assert a.shape == (64, 80) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    scaled = pmipmap._max_entropy_scaling(img.astype(np.float32))
    assert np.array_equal(scaled,
                          jmipmap._max_entropy_scaling(img.astype(np.float32)))


def test_thumbnail_mask_equals_jax_and_tensorstore_raises(tmp_path):
    from feabas_tpu import stitcher as jstitcher
    from feabas_tpu.common import imread
    st = jstitcher.Stitcher([f't{k}.png' for k in range(2)],
                            [(0, 0, 400, 320), (360, 4, 760, 324)],
                            root_dir='/x', resolution=4, name='s1')
    st.initialize_meshes()
    for k, m in enumerate(st.meshes):
        m.set_vertices(m.vertices('FIXED') + 3.0 * k, 'MOVING',
                       offset=m.offset('FIXED'))
    tform = str(tmp_path / 's1.h5')
    st.save_to_h5(tform)
    out_j = jmipmap.generate_thumbnail_mask(tform, str(tmp_path / 'j.png'),
                                            thumbnail_mip=2, mask_erode=2)
    out_p = pmipmap.generate_thumbnail_mask(tform, str(tmp_path / 'p.png'),
                                            thumbnail_mip=2, mask_erode=2)
    a, b = imread(out_p), imread(out_j)
    assert np.array_equal(a, b) and set(np.unique(a)) == {0, 255}
    assert (a == 0).mean() > 0.8
    # a directory that holds no volume raises in both packages
    for mod in (pmipmap, jmipmap):
        with pytest.raises(RuntimeError, match='not a tensorstore volume'):
            mod.create_thumbnail_tensorstore(str(tmp_path))
        with pytest.raises(RuntimeError, match='not a tensorstore volume'):
            mod.downsample_section_thumbnail(
                's9', str(tmp_path), str(tmp_path), {}, 2)


# --------------------------------- the CLI --------------------------------- #

def _thumb_workdir(root):
    """The test_thumbnail_e2e fixture: three 512^2 single-tile stitched
    sections with drift, thumbnails at mip 2. Returns (config dir, work
    dir, names, drift)."""
    import cv2
    from feabas_tpu import storage
    cfg = os.path.join(root, 'configs')
    shutil.copytree(os.path.join(REPO, 'configs'), cfg)
    wd = os.path.join(root, 'work_dir')
    storage.save_yaml(os.path.join(cfg, 'general_configs.yaml'), {
        'working_directory': wd, 'parallel_framework': 'serial',
        'full_resolution': 4, 'section_thickness': 30,
        'logfile_level': 'NONE', 'archive_level': 'NONE',
        'console_level': 'WARNING', 'cpu_budget': 2})
    rng = np.random.default_rng(42)
    h = w = 512
    base = texture(rng, h + 60, w + 60, blur=4)
    drift = np.array([[0.0, 0.0], [18.0, -12.0], [-10.0, 22.0]])
    names = [f'sec{z:04d}' for z in range(3)]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    for z, name in enumerate(names):
        cum = drift[:z + 1].sum(axis=0)
        img = cv2.remap(base, gx + 30 + np.float32(cum[0]),
                        gy + 30 + np.float32(cum[1]), cv2.INTER_LINEAR)
        _one_section(os.path.join(wd, 'stitched_sections', 'mip0'), img, name)
    storage.save_yaml(os.path.join(wd, 'configs', 'thumbnail_configs.yaml'), {
        'thumbnail_mip_level': 2,
        'downsample': {'max_mip': 2, 'thumbnail_highpass': False},
        'alignment': {
            'compare_distance': 1, 'save_feature_match': True,
            'feature_matching': {'detect_settings': {'sigma': 2.5,
                                                     'min_spacing': 6,
                                                     'num_features': 1500}},
            'block_matching': {'spacings': [40, 20], 'conf_thresh': 0.25,
                               'sigma': 2.5},
            'optimization': {
                'meshing_config': {'mesh_size': 40},
                'slide_window': {'window_size': 3, 'buffer_size': 1,
                                 'start_loc': 'L', 'residue_len': 2}}}})
    return cfg, wd, names, drift


def _run_cli(main, cfg, modes, monkeypatch):
    monkeypatch.setenv('FEABAS_TPU_CONFIG_DIR', cfg)
    jconfig.clear_config_caches()
    pconfig.clear_config_caches()
    try:
        for mode in modes:
            main(['--mode', mode])
    finally:
        jconfig.clear_config_caches()
        pconfig.clear_config_caches()


def test_port_thumbnail_cli_matches_jax(tmp_path, monkeypatch):
    """downsample, then alignment (matching, optimization, render) through
    the port's CLI, against the JAX package's CLI on a copy of the same
    work dir: the file checks of test_thumbnail_e2e, and the match H5 of
    pair 0 -> 1 read by the JAX package within 0.1 px of its own in median
    displacement."""
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    import thumbnail_main as jax_main
    from feabas_tpu.aligner import match_name, read_matches_from_h5
    from feabas_tpu.common import imread
    from feabas_tpu.mesh import Mesh
    from feabas_tpu_torch.scripts import thumbnail_main as port_main
    cfg_j, wd_j, names, drift = _thumb_workdir(str(tmp_path / 'jax'))
    cfg_p, wd_p, _, _ = _thumb_workdir(str(tmp_path / 'port'))
    _run_cli(jax_main.main, cfg_j, ('downsample', 'alignment'), monkeypatch)
    _run_cli(port_main.main, cfg_p, ('downsample', 'alignment'), monkeypatch)
    for n in names:
        tp = imread(os.path.join(wd_p, 'thumbnail_align', 'thumbnails',
                                 n + '.png'))
        tj = imread(os.path.join(wd_j, 'thumbnail_align', 'thumbnails',
                                 n + '.png'))
        assert abs(tp.shape[0] - 128) <= 2 and np.array_equal(tp, tj)
        assert os.path.exists(os.path.join(wd_p, 'stitched_sections', 'mip2',
                                           n, 'metadata.txt'))
    scale = 4.0                            # mip 2
    for a, b in zip(names[:-1], names[1:]):
        name = match_name(a, b)
        mp = read_matches_from_h5(os.path.join(
            wd_p, 'thumbnail_align', 'matches', name), target_resolution=4)
        mj = read_matches_from_h5(os.path.join(
            wd_j, 'thumbnail_align', 'matches', name), target_resolution=4)
        dp = np.median(mp.xy0 - mp.xy1, axis=0)
        dj = np.median(mj.xy0 - mj.xy1, axis=0)
        # 0.1 thumbnail px
        assert np.abs(dp - dj).max() < 0.1 * scale, (dp, dj)
        assert os.path.exists(os.path.join(wd_p, 'thumbnail_align',
                                           'feature_matches', name))
    m01 = read_matches_from_h5(os.path.join(
        wd_p, 'thumbnail_align', 'matches', match_name(names[0], names[1])),
        target_resolution=4)
    # xy0 = xy1 + drift1, within one thumbnail px
    assert np.allclose(np.median(m01.xy0 - m01.xy1, axis=0), drift[1],
                       atol=scale)
    for n in names:
        tp = Mesh.from_h5(os.path.join(wd_p, 'thumbnail_align', 'tform',
                                       n + '.h5'))
        tj = Mesh.from_h5(os.path.join(wd_j, 'thumbnail_align', 'tform',
                                       n + '.h5'))
        assert tp.num_vertices == tj.num_vertices
        assert np.abs(tp.vertices_w_offset('MOVING')
                      - tj.vertices_w_offset('MOVING')).max() < 0.5, n
    imgs = [imread(os.path.join(wd_p, 'thumbnail_align', 'aligned',
                                n + '.png')) for n in names]
    inner = (slice(20, -20), slice(20, -20))
    for z in (1, 2):
        a = imgs[0][inner].astype(float).ravel()
        b = imgs[z][inner].astype(float).ravel()
        ok = (a > 0) & (b > 0)
        assert np.corrcoef(a[ok], b[ok])[0, 1] > 0.9, z


def test_pair_list_reads_match_name_and_the_cli_takes_prefixes(workdir):
    from feabas_tpu import storage
    from feabas_tpu_torch.scripts import thumbnail_main
    names = [f's{z:02d}' for z in range(6)]
    with storage.File(os.path.join(str(workdir), 'thumbnail_align',
                                   'match_name.txt'), 'w') as f:
        f.write('s00 s05\n')        # long-range anchor
        f.write('s00 s01\n')        # duplicate of a neighbour pair: ignored
    pairs = thumbnail_main._pair_list(names, 1, str(workdir))
    assert ('s00', 's05') in pairs and pairs.count(('s00', 's01')) == 1
    assert len(pairs) == 6
    assert len(thumbnail_main._pair_list(names, 2, str(workdir))) == 10
    assert thumbnail_main.parse_args(['--mode', 'opt']).mode == 'optimization'
    assert thumbnail_main.parse_args(['--mode', 'align']).mode == 'alignment'
