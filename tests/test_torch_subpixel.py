"""The subpixel refinement of the thumbnail matches: the plain version of
``ops/subpixel.py`` (with the plain DoG) against the host route of
``thumbnail.refine_matches_subpixel``, the route the matcher chooses, the
refinement's counters and the benchmark's two readers of them; the kernel
against its plain version on the card (``cuda``)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from scipy.signal import correlate

from feabas_tpu_torch import common
from feabas_tpu_torch import config as pconfig
from feabas_tpu_torch import thumbnail, trace
from feabas_tpu_torch.ops import subpixel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, S = 32, 6
T = np.array([17.3, -9.6])

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU, asked for by name; the port's config caches start and end
    empty."""
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


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


def _matches(case, n, rng):
    """(xy0, xy1) of one sub-case on an n^2 pair shifted by T."""
    g = np.linspace(60, n - 60, 8)
    xy1 = np.stack(np.meshgrid(g, g + 0.4), -1).reshape(-1, 2)
    xy0 = xy1 + T + rng.normal(0, 1.0, xy1.shape)
    if case == 'out_of_bounds':
        # a third of the windows of image 1 reach past its left edge, a
        # third of those of image 0 past its bottom edge
        xy1[::3, 0] = rng.uniform(0, 15, xy1[::3].shape[0])
        xy0[1::3, 1] = n - rng.uniform(0, 21, xy0[1::3].shape[0])
    elif case == 'border_peak':
        # the true lag lies just past the search of 6 px
        xy0 = xy0 + rng.choice([-1, 1], xy0.shape) * rng.uniform(
            7, 9, xy0.shape)
    return xy0, xy1


def _peaks(img0, img1, xy0, xy1):
    """(interior, strong) of each in-bounds match, and the in-bounds mask,
    by scipy's valid correlation of the DoG windows: the route's tests,
    made here without its code."""
    f0 = common.masked_dog_filter(np.asarray(img0, np.float32), 3.5)
    f1 = common.masked_dog_filter(np.asarray(img1, np.float32), 3.5)
    c0, c1 = np.rint(xy0).astype(int), np.rint(xy1).astype(int)
    n = f0.shape[0]
    ok = ((c0 >= P // 2 + S) & (c0 < n - P // 2 - S)).all(1) \
        & ((c1 >= P // 2) & (c1 < n - P // 2)).all(1)
    interior, strong = [], []
    for (x0, y0), (x1, y1) in zip(c0[ok], c1[ok]):
        p0 = f0[y0 - P // 2 - S:y0 + P // 2 + S, x0 - P // 2 - S:x0 + P // 2 + S]
        p1 = f1[y1 - P // 2:y1 + P // 2, x1 - P // 2:x1 + P // 2]
        p0 = p0 - p0.mean()
        p1 = p1 - p1.mean()
        C = correlate(p0.astype(np.float64), p1.astype(np.float64), 'valid')
        py, px = np.unravel_index(np.argmax(C), C.shape)
        interior.append(0 < px < 2 * S and 0 < py < 2 * S)
        strong.append(C[py, px] > 0.1 * np.linalg.norm(p0)
                      * np.linalg.norm(p1) * P / (P + 2 * S))
    return np.array(interior), np.array(strong), ok


def _plain_route(monkeypatch):
    """The card route's code with the plain versions: the DoG and the
    per-match fit on CPU tensors, in the host route's place."""
    def shifts(img0, img1, c0, c1, sigma, patch, search):
        return thumbnail._subpixel_shifts_card(img0, img1, c0, c1, sigma,
                                               patch, search,
                                               torch.device('cpu'))
    monkeypatch.setattr(thumbnail, '_subpixel_shifts_host', shifts)


@pytest.mark.parametrize('case', ['in_bounds', 'out_of_bounds', 'weak_peak',
                                  'border_peak'])
def test_plain_version_equals_the_host_route(case, monkeypatch):
    """The same matches kept and the same shifts within 1e-3 px (f32 sums
    and a direct correlation for the FFT's), on the sub-case's matches."""
    n = 320
    img0, img1 = _shifted_pair(11, n, T)
    if case == 'weak_peak':
        # the left half of image 0 a grating across x, that of image 1 one
        # across y: there every lag correlates to nothing but rounding
        g = 40 * np.cos(np.arange(n) * np.pi / 8)
        img0[:, :180] = 128 + g[None, :180]
        img1[:, :180] = 128 + g[:, None]
    rng = np.random.default_rng(['in_bounds', 'out_of_bounds', 'weak_peak',
                                 'border_peak'].index(case))
    xy0, xy1 = _matches(case, n, rng)
    interior, strong, ok = _peaks(img0, img1, xy0, xy1)
    if case == 'in_bounds':
        assert ok.all() and (interior & strong).mean() > 0.9
    elif case == 'out_of_bounds':
        assert 8 <= (~ok).sum() and ok.sum() >= 4
    elif case == 'weak_peak':
        assert (interior & ~strong).sum() >= 8
    else:
        assert (~interior).sum() >= 10
    want = thumbnail.refine_matches_subpixel(img0, img1, xy0, xy1)
    _plain_route(monkeypatch)
    got = thumbnail.refine_matches_subpixel(img0, img1, xy0, xy1)
    kept = np.any(want != xy0, axis=1)
    assert np.array_equal(np.any(got != xy0, axis=1), kept)
    assert kept.sum() == (interior & strong).sum()
    assert np.abs(got - want).max() <= 1e-3
    if case == 'in_bounds':
        err = np.linalg.norm(got - (xy1 + T), axis=1)
        assert np.median(err) < 0.08


def test_wrapper_checks_what_the_kernel_takes():
    d = torch.zeros((100, 100))
    c = np.array([[50, 50]])
    assert subpixel.subpixel_refine(d, d, c, c).shape == (1, 3)
    assert subpixel.subpixel_refine(d, d, np.zeros((0, 2), int),
                                    np.zeros((0, 2), int)).shape == (0, 3)
    with pytest.raises(ValueError, match='outside the image'):
        subpixel.subpixel_refine(d, d, np.array([[21, 50]]), c)
    with pytest.raises(ValueError, match='outside the image'):
        subpixel.subpixel_refine(d, d, c, np.array([[50, 85]]))
    with pytest.raises(TypeError, match='float32'):
        subpixel.subpixel_refine(d.double(), d, c, c)
    with pytest.raises(ValueError, match='two'):
        subpixel.subpixel_refine(d, d, c, np.array([[50, 50], [50, 50]]))
    assert subpixel.shared_floats(32, 6) == 44 * 44 + 3 * 32 * 32 + 13 * 13


# ------------------------------ the route ------------------------------ #

@pytest.mark.parametrize('device', [None, 'cpu', torch.device('cpu')])
def test_no_device_or_the_cpu_takes_the_host_route(device, monkeypatch):
    """The host route, bit for bit, and the counters: one call, none on
    the card, the kept matches those that moved."""
    img0, img1 = _shifted_pair(6, 256, T)
    xy1 = np.stack(np.meshgrid(np.linspace(40, 210, 4),
                               np.linspace(40.5, 210, 4)), -1).reshape(-1, 2)
    xy0 = xy1 + T + np.random.default_rng(6).normal(0, 1.0, xy1.shape)
    want = thumbnail.refine_matches_subpixel(img0, img1, xy0, xy1)

    def card(*a, **k):
        raise AssertionError('the card route was taken')
    monkeypatch.setattr(thumbnail, '_subpixel_shifts_card', card)
    trace.reset_counters()
    got = thumbnail.refine_matches_subpixel(img0, img1, xy0, xy1,
                                            device=device)
    assert np.array_equal(got, want)
    c = trace.counters()
    assert c['thumbnail.subpixel_calls'] == 1
    assert c.get('thumbnail.subpixel_on_device', 0) == 0
    assert c['thumbnail.subpixel_kept'] == np.any(got != xy0, axis=1).sum() > 8


def test_a_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('this host has a card')
    img = np.zeros((128, 128), np.float32)
    xy = np.array([[64.0, 64.0]])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        thumbnail.refine_matches_subpixel(img, img, xy, xy, device='cuda')


@pytest.mark.parametrize('made_here', [True, False])
def test_the_matcher_refines_where_the_features_were_made(made_here,
                                                           monkeypatch):
    """Features made here on the device (the CPU, by name) send the
    refinement to that device; keypoints carried in without device
    descriptors (``des_dev`` None) send it to the host route."""
    img0, img1 = _shifted_pair(13, 256, np.array([9.4, -5.2]))
    seen = []
    refine = thumbnail.refine_matches_subpixel

    def spy(*a, **k):
        seen.append(k.get('device'))
        return refine(*a, **k)
    monkeypatch.setattr(thumbnail, 'refine_matches_subpixel', spy)
    s = {'detect_settings': {'min_spacing': 12, 'num_features': 300},
         'max_rounds': 1}
    if not made_here:
        for key in ('kps0', 'kps1'):
            kp = thumbnail.prepare_image(img0 if key == 'kps0' else img1, **s)
            kp.des_dev = None
            s[key] = kp
    m = thumbnail.match_two_thumbnails_LRadon(img0, img1, **s)
    assert m is not None and len(seen) == 1
    assert seen[0] == (torch.device('cpu') if made_here else None)


# ---------------------- the benchmark's two readers ---------------------- #

def _reader(name):
    path = os.path.join(REPO, 'bench_port', 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location('metric_' + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_readers_read_the_counters_and_none_without_them():
    device_pct = _reader('thumbnail.subpixel_device_pct')
    kept_pct = _reader('thumbnail.subpixel_kept_pct')
    trace.reset_counters()
    assert device_pct(None) is None and kept_pct(None) is None
    # a program that counts coarse matches and not the refinement
    trace.count('thumbnail.coarse_matches', 1344)
    assert device_pct(None) is None and kept_pct(None) is None
    trace.count('thumbnail.subpixel_calls', 4)
    trace.count('thumbnail.subpixel_on_device', 3)
    trace.count('thumbnail.subpixel_kept', 336)
    assert device_pct(None) == 75.0 and kept_pct(None) == 25.0
    trace.reset_counters()
    trace.count('thumbnail.subpixel_calls')
    assert device_pct(None) == 0.0 and kept_pct(None) is None
    trace.reset_counters()


# ------------------------------ on the card ------------------------------ #

@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The thumbnail cell's size: a 4096^2 pair of a sigma-1.5 texture with
    1,369 matches (chip_smoke.py's phase-3 case), the same kept set and
    shifts within 1e-4 px; then windows at every bound and one match. Each
    launch counted."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    from feabas_tpu_torch import device
    sys.path.insert(0, REPO)
    import chip_smoke
    case = chip_smoke.subpixel_case(torch.device('cuda'))
    before = device.launch_counts()['subpixel_refine']
    err, kept, _ = chip_smoke.subpixel_compare(case)
    assert device.launch_counts()['subpixel_refine'] == before + 1
    assert kept > 0.9 * case['c0'].shape[0] and err <= 1e-4
    h, w = case['dog0'].shape
    for m0, m1 in ((22, 16), (23, 17)):
        c0 = np.array([[m0, m0], [w - m0, h - m0], [m0, h // 2]])
        c1 = np.array([[m1, m1], [w - m1, h - m1], [w // 2, m1]])
        chip_smoke.subpixel_compare(dict(case, c0=c0, c1=c1))
    chip_smoke.subpixel_compare(dict(case, c0=case['c0'][:1],
                                     c1=case['c1'][:1]))
