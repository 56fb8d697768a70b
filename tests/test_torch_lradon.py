"""The port's thumbnail feature pipeline (``feabas_tpu_torch/ops/lradon.py``:
plain versions here, the CUDA kernels on a card) against the JAX package's
device programs on the same inputs: the detector (order, ties, the even
window), the stencil table and rotation variants, the descriptors, the
masked and unmasked match, and the staged against the combined calls."""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the JAX package's storage imports h5py at load; on a host without it
# (the GPU machine) the port's standard-HDF5 subset stands in for it in
# this test process (the port itself needs no such patch)
try:
    import h5py  # noqa: F401
except ImportError:
    from feabas_tpu_torch import _h5lite
    sys.modules['h5py'] = _h5lite

from feabas_tpu.ops import lradon as jlradon
from feabas_tpu import thumbnail as jthumb
from feabas_tpu_torch import config as pconfig
from feabas_tpu_torch import thumbnail as pthumb
from feabas_tpu_torch.ops import lradon

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


def _section(seed=5, n=384):
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    w = gaussian_filter(rng.normal(0, 1, (n + 64, n + 64)), 3)
    return (w / w.std() * 40 + 128).clip(0, 255).astype(np.float32)


def _int_mask(shape):
    mask = np.zeros(shape, np.int32)
    mask[:, :190] = 1
    mask[:, 200:] = 2
    return mask


# ------------------------------- detector ------------------------------- #

@pytest.mark.parametrize('masked', [False, True])
def test_detect_matches_jax(workdir, masked):
    """Same count, same order, same integer peaks; xy within 1e-4 px (f32
    quadratic fits of blur sums taken in another order), responses within
    1e-5 relative."""
    img = _section()[:384, :384]
    mask = _int_mask(img.shape) if masked else None
    kw = dict(mask=mask, sigma=3.0, min_spacing=8, num_features=300)
    xy_j, resp_j, iyx_j = jlradon.detect_log_device(img, **kw)
    xy_p, resp_p, iyx_p = lradon.detect_log_device(img, **kw)
    assert xy_p.shape == xy_j.shape == (300, 2) and xy_p.dtype == np.float64
    assert np.array_equal(iyx_p, iyx_j)
    assert np.abs(xy_p - xy_j).max() < 1e-4
    assert np.abs(resp_p - resp_j).max() < 1e-5 * resp_j.max()
    if masked:
        assert not ((iyx_p[:, 1] >= 190) & (iyx_p[:, 1] < 200)).any()


def test_detect_keeps_the_jax_order_among_tied_responses(workdir):
    """A periodic image has bit-equal responses at its repeated peaks:
    the port orders them as ``lax.top_k`` does, lower flat index first."""
    block = _section(seed=11)[:96, :96]
    img = np.tile(block, (4, 4))
    kw = dict(sigma=3.0, min_spacing=8, num_features=400)
    _, resp_j, iyx_j = jlradon.detect_log_device(img, **kw)
    _, resp_p, iyx_p = lradon.detect_log_device(img, **kw)
    assert np.unique(resp_p).size < 0.6 * resp_p.size      # ties exist
    assert np.array_equal(iyx_p, iyx_j)
    flat = iyx_p[:, 0] * img.shape[1] + iyx_p[:, 1]
    tied = resp_p[1:] == resp_p[:-1]
    assert tied.sum() > 50 and (np.diff(flat)[tied] > 0).all()


def _xla_peaks(f, size):
    """The JAX detector's peak test on |f| (ops/lradon._detect_body)."""
    f = jnp.asarray(np.abs(f))
    mx = jax.lax.reduce_window(f, -jnp.inf, jax.lax.max, (size, 1), (1, 1),
                               'SAME')
    mx = jax.lax.reduce_window(mx, -jnp.inf, jax.lax.max, (1, size), (1, 1),
                               'SAME')
    return np.asarray((f >= mx) & (f > 0))


@pytest.mark.parametrize('size', [3, 7, 10])
def test_peak_window_follows_the_xla_rule(size):
    """An even window reaches (size - 1) // 2 before the pixel and
    size // 2 after it. At size 10: a weaker peak 5 px before a stronger
    one is suppressed, one 5 px after it survives (scipy's window would
    decide both the other way). Random planes agree everywhere, plateaus
    and the -inf border included."""
    f = np.zeros((48, 48), np.float32)
    f[20, 20], f[20, 25] = 1.0, 2.0        # weaker first, along x
    f[40, 25], f[40, 20] = 1.0, 2.0        # weaker second, along x
    f[5, 40], f[10, 40] = 1.0, 2.0         # weaker first, along y
    f[30, 5:9] = 3.0                       # a plateau: every pixel a peak
    got = lradon.peak_response(torch.from_numpy(f), None, size).numpy()
    peaks = np.isfinite(got)
    assert np.array_equal(peaks, _xla_peaks(f, size))
    assert np.array_equal(got[peaks], np.abs(f)[peaks])
    assert peaks[30, 5:9].all()
    if size == 10:
        assert not peaks[20, 20] and peaks[40, 25] and not peaks[5, 40]
    rng = np.random.default_rng(size)
    g = rng.integers(-3, 4, (37, 53)).astype(np.float32)
    m = (rng.random(g.shape) > 0.3).astype(np.float32)
    got = lradon.peak_response(torch.from_numpy(g), torch.from_numpy(m),
                               size).numpy()
    assert np.array_equal(np.isfinite(got), _xla_peaks(g, size) & (m > 0))


# ----------------------- stencil table and variants ----------------------- #

GEOMS = [(6, 8, 3, 15), (4, 6, 1, 9.5)]


@pytest.mark.parametrize('geom', GEOMS)
def test_stencil_table_matches_jax(geom):
    D, offs, Rp = lradon._desc_params(*geom)
    Dj, offs_j, Rp_j = jlradon._desc_params(*geom)
    assert (D, Rp) == (Dj, Rp_j) and np.array_equal(offs, offs_j)
    W = lradon._stencil_table(geom[0], geom[1], geom[2], D, offs, Rp)
    Wj = np.asarray(jlradon._stencil_table(geom[0], geom[1], geom[2], Dj,
                                           offs_j, Rp_j))
    assert W.shape == Wj.shape == (4, geom[0] * geom[1], (2 * Rp + 1) ** 2)
    assert W.dtype == np.float32 and np.abs(W - Wj).max() <= 1e-7
    Wd, off, wts = lradon._stencil_tensors(geom[0], geom[1], geom[2], D,
                                           offs, Rp, torch.device('cpu'))
    assert torch.equal(Wd, torch.from_numpy(W))
    want_off, want_wts = lradon._stencil_taps(W[0])
    assert np.array_equal(off.numpy(), want_off)
    assert np.array_equal(wts.numpy(), want_wts)


@pytest.mark.parametrize('geom', GEOMS + [(6, 8, 3, 30), (6, 8, 3, 45)])
def test_corner_planes_are_one_plane_shifted(geom):
    """Corner plane (cy, cx) is plane (0, 0) shifted by (cx, cy) pixels,
    and plane (0, 0) is zero on the patch's last row and column: the
    kernel's one-plane form rests on this. It holds exactly in the f32
    table both versions use; in f64 the same taps differ by at most one
    ulp (a tap position x + cx rounds apart from x)."""
    D, offs, Rp = lradon._desc_params(*geom)
    Dp = 2 * Rp + 1
    for W, atol in ((lradon._stencil_table(
            geom[0], geom[1], geom[2], D, offs, Rp), 0.0),
            (lradon._stencil_table64(
                geom[0], geom[1], geom[2], D, offs, Rp), 1e-15)):
        W = W.reshape(2, 2, -1, Dp, Dp)
        W0 = W[0, 0]
        assert not W0[:, -1, :].any() and not W0[:, :, -1].any()
        for cy in (0, 1):
            for cx in (0, 1):
                shifted = np.zeros_like(W0)
                shifted[:, cy:, cx:] = W0[:, :Dp - cy, :Dp - cx]
                assert np.array_equal(W[cy, cx] != 0, shifted != 0)
                assert np.abs(W[cy, cx] - shifted).max() <= atol


@pytest.mark.parametrize('geom', GEOMS + [(6, 8, 3, 45)])
def test_sparse_taps_rebuild_the_corner_plane(geom):
    """The kernel's tap table: bin q's non-zero taps of plane (0, 0) in
    ascending p, padded with (0, 0.0) to the longest bin, rebuild the
    plane exactly."""
    D, offs, Rp = lradon._desc_params(*geom)
    W0 = lradon._stencil_table(geom[0], geom[1], geom[2], D, offs, Rp)[0]
    off, wts = lradon._stencil_taps(W0)
    counts = (W0 != 0).sum(1)
    assert off.dtype == np.int16 and wts.dtype == np.float32
    assert off.shape == wts.shape == (counts.max(), W0.shape[0])
    dense = np.zeros_like(W0)
    np.add.at(dense, (np.broadcast_to(np.arange(W0.shape[0]), off.shape),
                      off.astype(np.int64)), wts)
    assert np.array_equal(dense, W0)
    for q, n in enumerate(counts):
        assert (np.diff(off[:n, q]) > 0).all()
        assert not off[n:, q].any() and not wts[n:, q].any()
    with pytest.raises(ValueError, match='16 bits'):
        lradon._stencil_taps(np.zeros((2, 1 << 15 | 1), np.float32))


def _blended_descriptors(img, z, f, off, wts, Rp, proj_num):
    """The kernel's form in f64: each keypoint's patch blended by its
    fractional offset (reads clamped into the image), times the sparse
    plane (0, 0), then the normalisation."""
    h, w = img.shape
    Dp, pad = 2 * Rp + 1, Rp + 1
    ar = np.arange(Dp)
    out = []
    for (zx, zy), (fx, fy) in zip(z, f):
        ys = np.clip(zy - pad + ar, 0, h - 1)
        ys1 = np.clip(zy - pad + ar + 1, 0, h - 1)
        xs = np.clip(zx - pad + ar, 0, w - 1)
        xs1 = np.clip(zx - pad + ar + 1, 0, w - 1)
        bl = ((1 - fx) * (1 - fy) * img[np.ix_(ys, xs)]
              + fx * (1 - fy) * img[np.ix_(ys, xs1)]
              + (1 - fx) * fy * img[np.ix_(ys1, xs)]
              + fx * fy * img[np.ix_(ys1, xs1)]).ravel()
        d = (wts * bl[off.astype(np.int64)]).sum(0)
        d = d - d.mean()
        out.append(d / max(np.linalg.norm(d), 1e-6))
    return np.asarray(out).reshape(len(out), proj_num, -1)


@pytest.mark.parametrize('geom', GEOMS)
def test_blended_patch_form_equals_the_dense_form(geom):
    """sum_c wc_c (W_c . patch) == W_0 . blend(patch) in f64 (within 1e-10)
    on seeded keypoints, every border and corner included, against the
    plain version's dense product run in f64."""
    D, offs, Rp = lradon._desc_params(*geom)
    W64 = lradon._stencil_table64(geom[0], geom[1], geom[2], D, offs, Rp)
    off, wts = lradon._stencil_taps(W64[0])
    rng = np.random.default_rng(9)
    h, w = 70, 90
    img = rng.uniform(0, 255, (h, w))
    xy = rng.uniform(0, 1, (60, 2)) * [w - 1, h - 1]
    e = 1.0 - 2.0 ** -20
    xy[:12] = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (w / 2, 0),
               (0, h / 2), (e, e), (w - 2 + e, h - 2 + e), (5 + e, 7),
               (5, 7 + e), (1, 1), (w - 2, h - 2)]
    z0 = np.floor(xy)
    z = z0.astype(np.int64) + 1
    f = xy - z0
    want = lradon.lradon_patch_plain(
        torch.from_numpy(img), torch.from_numpy(z), torch.from_numpy(f),
        torch.from_numpy(W64), geom[0], Rp).numpy()
    got = _blended_descriptors(img, z, f, off, wts, Rp, geom[0])
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-10


def test_match_plan_covers_every_column_tile_once():
    """The match kernels' grid: K0 padded to whole tiles, pass 1 and pass 2
    split over columns into chunks that cover every column tile once, in
    order, none empty."""
    T = lradon.MATCH_TILE
    for K0, K1, nvar in ((5000, 5000, 12), (4096, 64, 12), (3001, 100, 12),
                         (1000, 777, 1), (1, 1, 12), (300, 200, 8)):
        K0p, c1, c2 = lradon._match_plan(K0, K1, nvar, 132)
        tiles = K0p // T
        assert K0p >= K0 and K0p - K0 < T and K0p % T == 0
        for chunks in (c1, c2):
            assert 1 <= chunks <= tiles
            # csrc/lradon_match.cu chunk_tiles
            spans = [(tiles * c // chunks, tiles * (c + 1) // chunks)
                     for c in range(chunks)]
            assert spans[0][0] == 0 and spans[-1][1] == tiles
            assert all(a < b for a, b in spans)
            assert all(spans[i][1] == spans[i + 1][0]
                       for i in range(chunks - 1))
    # the on-path shape fills the card in pass 1 without a split, and
    # pass 2 splits into 6 chunks of 6-7 column tiles
    assert lradon._match_plan(5000, 5000, 12, 132) == (5120, 1, 6)


def test_variants_match_jax_and_the_kernel_permutations():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(5, 6, 8)).astype(np.float32)
    want = np.asarray(jlradon._variants(jnp.asarray(d), 6))
    got = lradon._variants(torch.from_numpy(d), 6)
    assert got.shape == (12, 5, 48) and np.array_equal(got.numpy(), want)
    perms = lradon._variant_perms(6, 8, torch.device('cpu')).numpy()
    assert perms.dtype == np.int32
    assert np.array_equal(perms[0], np.arange(48))
    assert np.array_equal(d.reshape(5, -1)[:, perms].transpose(1, 0, 2), want)


# ------------------------------ descriptors ------------------------------ #

def test_descriptors_match_jax(workdir):
    """200 keypoints, some beyond every border and some on it: the same
    padded shape, unit descriptors within 1e-5 (f32 sums of 2401 products
    in another order)."""
    img = _section(seed=33)[:300, :300]
    rng = np.random.default_rng(3)
    xy = rng.uniform(-3, 303, (200, 2)).astype(np.float32)
    xy[:8] = [[0, 0], [299, 0], [0, 299], [299, 299], [150, 0], [0, 150],
              [299.0, 150.5], [150.5, 299.0]]
    des_j, n_j = jlradon.lradon_descriptors_device(img, xy)
    des_p, n_p = lradon.lradon_descriptors_device(img, xy)
    assert n_p == n_j == 200 and tuple(des_p.shape) == des_j.shape == (256, 6, 8)
    assert np.abs(des_p.numpy() - np.asarray(des_j)).max() < 1e-5
    nrm = np.linalg.norm(des_p.numpy()[:200].reshape(200, -1), axis=-1)
    assert np.abs(nrm - 1).max() < 1e-5
    empty, n0 = lradon.lradon_descriptors_device(img, np.zeros((0, 2)))
    assert n0 == 0 and tuple(empty.shape) == (64, 6, 8)


# --------------------------------- match --------------------------------- #

def _features(img, **kw):
    """The JAX package's features, and the port's descriptor tensor of the
    same values (so both matchers see the same descriptors)."""
    feat = jlradon.features_device(img, **kw)
    return feat, torch.from_numpy(np.array(feat['des_dev']))


def _pairs():
    a = _section(seed=45)[:320, :320]
    b = np.ascontiguousarray(_section(seed=45)[24:344, 16:336])
    c = _section(seed=21)[:320, :320]
    return {'translated': (a, b), 'half_turn': (c, c[::-1, ::-1].copy())}


@pytest.mark.parametrize('exhaustive', [True, False])
@pytest.mark.parametrize('pair', ['translated', 'half_turn'])
def test_match_matches_jax(workdir, pair, exhaustive):
    """best_rot, idx0, idx1 equal, conf within 1e-5, on the same
    descriptors; the half-turn pair needs the second half of the variants."""
    img0, img1 = _pairs()[pair]
    f0, d0 = _features(img0, min_spacing=10)
    f1, d1 = _features(img1, min_spacing=10)
    want = jlradon.match_lradon_device(f0['des_dev'], f0['n'], f1['des_dev'],
                                       f1['n'], exhaustive=exhaustive,
                                       conf_thresh=0.3)
    got = lradon.match_lradon_device(d0, f0['n'], d1, f1['n'],
                                     exhaustive=exhaustive, conf_thresh=0.3)
    assert got[3] == want[3]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert np.allclose(got[2], want[2], rtol=0, atol=1e-5)
    if exhaustive:
        assert want[0].size >= 8
        assert (got[3] >= 6) == (pair == 'half_turn')
    assert lradon.match_lradon_device(d0, 0, d1, f1['n'])[0].size == 0


def test_masked_match_matches_jax_and_equals_compacted(workdir):
    """A random active subset: the masked match on resident descriptors
    equals the JAX package's, and equals the re-padded compacted match."""
    img0, img1 = _pairs()['translated']
    f0, d0 = _features(img0, min_spacing=10)
    f1, d1 = _features(img1, min_spacing=10)
    rng = np.random.default_rng(0)
    act0 = rng.random(f0['n']) > 0.3
    act1 = rng.random(f1['n']) > 0.3
    m0 = np.zeros(d0.shape[0], bool)
    m0[:f0['n']] = act0
    m1 = np.zeros(d1.shape[0], bool)
    m1[:f1['n']] = act1
    want = jlradon.match_lradon_device_masked(f0['des_dev'], m0,
                                              f1['des_dev'], m1,
                                              conf_thresh=0.3)
    got = lradon.match_lradon_device_masked(d0, m0, d1, m1, conf_thresh=0.3)
    assert got[3] == want[3] and want[0].size >= 8
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert np.abs(got[2] - want[2]).max() < 1e-5
    k0 = pthumb.KeyPoints(f0['xy'], f0['resp'])
    k0.des = f0['des']
    k1 = pthumb.KeyPoints(f1['xy'], f1['resp'])
    k1.des = f1['des']
    i0, i1, conf_c, rot_c = pthumb.match_LRadon_feature(
        k0.filter_by_mask(act0), k1.filter_by_mask(act1), conf_thresh=0.3)
    assert rot_c == got[3]
    assert np.array_equal(got[0], np.nonzero(act0)[0][i0])
    assert np.array_equal(got[1], np.nonzero(act1)[0][i1])
    assert np.abs(got[2] - conf_c).max() < 1e-5
    none = lradon.match_lradon_device_masked(d0, np.zeros_like(m0), d1, m1)
    assert none[0].size == 0 and none[3] == 0


def test_match_ties_and_empty_rows_follow_first_wins():
    """Duplicate descriptors tie exactly: the first column, the first row
    and the first variant win, ``second`` equals ``top``; a row with no
    valid partner has top -inf, i0 0, conf 0."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(6, 2, 4)).astype(np.float32)
    base /= np.linalg.norm(base.reshape(6, -1), axis=1)[:, None, None]
    d0 = torch.from_numpy(np.concatenate([base, base[:2]]))     # cols 6, 7
    d1 = torch.from_numpy(np.concatenate([base[:3], base[:1]]))  # row 3
    v0 = torch.ones(8, dtype=torch.bool)
    v1 = torch.tensor([True, True, True, True])
    args = (jnp.asarray(d0.numpy()), jnp.asarray(v0.numpy()),
            jnp.asarray(d1.numpy()), jnp.asarray(v1.numpy()))
    for exhaustive in (True, False):
        want = jlradon._match_core_masked(*args, 2, exhaustive)
        i0, top, conf, mutual, rot = lradon.lradon_match(d0, v0, d1, v1, 2,
                                                         exhaustive)
        assert int(rot) == int(want[4]) == 0
        assert i0.tolist() == np.asarray(want[0]).tolist() == [0, 1, 2, 0]
        assert np.abs(top.numpy() - np.asarray(want[1])).max() < 1e-6
        assert np.abs(conf.numpy()[:2]).max() < 1e-6      # second == top
        assert mutual.tolist() == np.asarray(want[3]).tolist() \
            == [True, True, True, False]
    v0[:] = False
    i0, top, conf, mutual, rot = lradon.lradon_match(d0, v0, d1, v1, 2, True)
    assert i0.tolist() == [0] * 4 and torch.isinf(top).all() and int(rot) == 0
    assert conf.tolist() == [0.0] * 4
    assert mutual.tolist() == [True, False, False, False]


# ------------------------- staged against combined ------------------------- #

def test_features_device_equals_the_staged_chain_and_jax(workdir):
    img = _section(seed=41)[:384, :384]
    mask = _int_mask(img.shape)
    kw = dict(sigma=3.0, min_spacing=8, num_features=400)
    feat = lradon.features_device(img, mask=mask, **kw)
    kp = pthumb.detect_extrema_log(img, mask=mask, **kw)
    kp = pthumb.extract_LRadon_feature(img, kp)
    assert feat['n'] == kp.num_points == 400
    assert np.abs(feat['xy'] - kp.xy).max() < 1e-5
    assert np.array_equal(feat['cls'], kp.class_id)
    assert np.abs(feat['des'] - kp.des).max() < 1e-5
    want = jlradon.features_device(img, mask=mask, **kw)
    assert tuple(feat['des_dev'].shape) == want['des_dev'].shape
    assert np.array_equal(feat['iyx'], want['iyx'])
    assert np.array_equal(feat['cls'], want['cls'])
    # a few f32 ulps at 384 px (3e-5 each): the quadratic fit divides two
    # blur-sum differences, which the packages sum in another order
    assert np.abs(feat['xy'] - want['xy']).max() < 5e-4
    # the fractional offsets differ by the xy difference above
    assert np.abs(feat['des'] - want['des']).max() < 5e-4


def test_pair_features_equal_the_staged_chain_and_jax(workdir):
    img0, img1 = _pairs()['translated']
    kw = dict(min_spacing=10, conf_thresh=0.3)
    f0, f1, match = lradon.pair_features_device(img0, img1, **kw)
    s0 = lradon.features_device(img0, min_spacing=10)
    s1 = lradon.features_device(img1, min_spacing=10)
    assert np.array_equal(f0['des'], s0['des'])
    assert np.array_equal(f1['des'], s1['des'])
    staged = lradon.match_lradon_device(s0['des_dev'], s0['n'], s1['des_dev'],
                                        s1['n'], conf_thresh=0.3)
    for a, b in zip(match, staged):
        assert np.array_equal(a, b)
    j0, j1, want = jlradon.pair_features_device(img0, img1, **kw)
    assert (f0['n'], f1['n']) == (j0['n'], j1['n'])
    assert match[3] == want[3]
    assert np.array_equal(match[0], want[0])
    assert np.array_equal(match[1], want[1])
    assert np.abs(match[2] - want[2]).max() < 1e-3


def test_prepare_image_sets_the_device_tensor_and_pickling_drops_it(workdir):
    img = _section(seed=43)[:256, :256]
    kp = pthumb.prepare_image(img, detect_settings={'min_spacing': 10})
    assert isinstance(kp.des_dev, torch.Tensor)
    assert kp.des.shape[0] == kp.num_points
    assert kp.des_dev.shape[0] == lradon._kd_bucket(kp.num_points, 5000)
    kp2 = pickle.loads(pickle.dumps(kp))
    assert kp2.des_dev is None and kp2.des.shape == kp.des.shape
    want = jthumb.prepare_image(img, detect_settings={'min_spacing': 10,
                                                      'use_device': True},
                                extract_settings={'use_device': True})
    assert kp.num_points == want.num_points
    assert np.abs(kp.xy - want.xy).max() < 5e-4     # a few f32 ulps


def test_wrappers_refuse_what_the_kernels_do_not_take():
    f = torch.zeros((8, 8))
    with pytest.raises(ValueError, match='CUDA tensor'):
        lradon._require_cuda('x', f=f)
    assert [lradon._kd_bucket(n, 5000) for n in (0, 1, 64, 65, 4097, 5000)] \
        == [64, 64, 64, 128, 5000, 5000]


# ------------------------------ on the card ------------------------------ #

def _smoke():
    """chip_smoke.py at the repo's root: its phase 3 owns the case list and
    the comparison, so the script still runs from a bare checkout without
    the tests and both hold the kernels to the same cases."""
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


PEAK_CASES = ['2048^2 size 10', '2048^2 size 10, mask', '1x1', '7x300',
              'size 3', 'size 7', 'plateau', 'size 1', 'size 2', 'size 31',
              'size 32', '2049 x 2047 size 10, mask']
PATCH_CASES = ['K 5000', 'K 64, borders and corners', 'K 4096, 3000x2000',
               'radius 30, groups of 4', 'radius 45, one per block',
               '4 x 6 bins, width 1, radius 9.5']
MATCH_CASES = ['5000 x 5000', '64 x 4096', 'side 0 masked', 'duplicates',
               'not exhaustive', 'variant 0', 'variant 1..P-1',
               'variant P..2P-1', 'dlen 24 (4 x 6)', '100 x 3001']


@pytest.mark.cuda
@pytest.mark.parametrize('kernel,case', (
    [('peak_detect', c) for c in PEAK_CASES]
    + [('lradon_patch', c) for c in PATCH_CASES]
    + [('lradon_match', c) for c in MATCH_CASES]))
def test_kernel_matches_plain_on_card(kernel, case):
    """Each kernel against its plain version on the card, over the edge
    list of chip_smoke.py's phase 3, each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    from feabas_tpu_torch import device
    smoke = _smoke()
    cases = dict(smoke.lradon_cases(torch.device('cuda'), kernel))
    assert sorted(cases) == sorted({'peak_detect': PEAK_CASES,
                                    'lradon_patch': PATCH_CASES,
                                    'lradon_match': MATCH_CASES}[kernel])
    before = device.launch_counts()[kernel]
    smoke.lradon_compare(kernel, cases[case]())
    assert device.launch_counts()[kernel] == before + 1
