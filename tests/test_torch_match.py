"""The port's fused match schedule and tile-pair matcher against the JAX
package on the same pair."""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the JAX package's storage imports h5py at load; on a host without it
# (the GPU machine) the port's standard-HDF5 subset stands in for it in
# this test process (the port itself needs no such patch)
try:
    import h5py  # noqa: F401
except ImportError:
    from feabas_tpu_torch import _h5lite
    sys.modules['h5py'] = _h5lite

from feabas_tpu import matcher as jmatcher
from feabas_tpu.ops import match_loop as jloop
from feabas_tpu.utils.synthetic import texture
from feabas_tpu_torch import matcher, state
from feabas_tpu_torch.ops import match_loop
from feabas_tpu_torch.ops.filters import masked_dog_filter
from feabas_tpu_torch.ops.xcorr import _peak_and_subpixel

# the tier-1 run shares the cores among several pytest workers: one torch
# thread per worker avoids oversubscription
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')

# img1's true origin in img0's frame, and the stage prior the matcher gets
TRUE_T = np.array([131.0, 3.0])
PRIOR = (128.0, 0.0)


def _pair(seed):
    rng = np.random.default_rng(seed)
    world = texture(rng, 320, 560)
    img0 = world[0:300, 0:400].copy()
    img1 = world[3:303, 131:531].copy()
    return img0, img1


def _jax_prep(img0, img1):
    prep = jmatcher.stitching_matcher(img0, img1, fused_prep_only=True,
                                      stage_prior=PRIOR, conf_thresh=0.25)
    assert isinstance(prep, dict)
    return prep


def _run_jax(prep):
    rounds = tuple({k: jnp.asarray(v) for k, v in rd.items()}
                   for rd in prep['rounds'])
    coarse = {k: jnp.asarray(v) for k, v in prep['coarse'].items()}
    args = [jnp.asarray(prep[k]) for k in state.FUSED_ARRAY_KEYS]
    (src0, src1, pos1, verts0_1, shape1, tris1, mult, poisson,
     shape0, tris0, mult0, poisson0, pos0) = args
    return np.asarray(jloop.fused_rounds(
        src0, src1, pos1, verts0_1, shape1, tris1, mult, poisson, rounds,
        prep['meta'], shape0, tris0, mult0, poisson0, pos0,
        lam_ratio=prep['lam_ratio'], sigma=prep['sigma'],
        conf_thresh=prep['conf_thresh'], coarse=coarse,
        coarse_meta=prep['coarse_meta'], env_norm=prep['env_norm']))


def _run_port(preps, dtype=torch.float64):
    t = state.to_tensors(state.stack_preps(preps), torch.device('cpu'),
                         float_dtype=dtype)
    p0 = preps[0]
    return match_loop.fused_rounds_batched(
        t['src0'], t['src1'], t['pos1'], t['verts0_1'], t['shape1'],
        t['tris1'], t['mult'], t['poisson'], t['rounds'], p0['meta'],
        t['shape0'], t['tris0'], t['mult0'], t['poisson0'], t['pos0'],
        lam_ratio=p0['lam_ratio'], sigma=p0['sigma'],
        conf_thresh=p0['conf_thresh'], coarse=t['coarse'],
        coarse_meta=p0['coarse_meta'], env_norm=p0['env_norm']).numpy()


def test_fused_rounds_core_matches_jax():
    # the JAX package runs f64 here (x64 tests): the port in f64 must give
    # the same packed output to rounding
    prep = _jax_prep(*_pair(7))
    want = _run_jax(prep)
    got = _run_port([prep])[0]
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-4


def test_fused_rounds_core_f32_stays_near_f64():
    # in f32, far mesh corners and border blocks move by a few tenths of a
    # pixel between any two f32 implementations (the JAX package's own f32
    # run differs from its f64 run by the same amount on this pair);
    # interior peaks stay within a few hundredths
    prep = _jax_prep(*_pair(7))
    ref = _run_port([prep])[0]
    got = _run_port([state.cast_floats(prep)], torch.float32)[0]
    V = prep['pos1'].shape[0]
    n, nb = prep['valid_rounds'][-1][:2]
    ok = prep['rounds'][-1]['env_ok'][:n] > 0
    d = slice(V, V + n)
    assert np.abs(got[d] - ref[d]).max() < 0.5
    assert np.abs(got[d][ok] - ref[d][ok]).max() < 0.05


def test_pair_axis_runs_each_pair_alone():
    preps = [_jax_prep(*_pair(s)) for s in (7, 8)]
    assert jmatcher._fused_signature(preps[0]) == jmatcher._fused_signature(preps[1])
    both = _run_port(preps)
    for p, got in zip(preps, both):
        alone = _run_port([p])[0]
        assert np.abs(got - alone).max() < 1e-8


@pytest.mark.parametrize('fused', [True, False])
def test_stitching_matcher_matches_jax(fused):
    img0, img1 = _pair(11)
    kw = dict(stage_prior=PRIOR, conf_thresh=0.25, fused_rounds=fused)
    want = jmatcher.stitching_matcher(img0, img1, **kw)
    # f64 on both sides (x64 tests): the same matches to rounding
    got = matcher.stitching_matcher(img0, img1, device='cpu',
                                    dtype=torch.float64, **kw)
    assert got is not None and want is not None
    assert got.xy0.shape == want.xy0.shape
    assert np.abs(got.xy0 - want.xy0).max() < 1e-3
    assert np.abs(got.xy1 - want.xy1).max() < 1e-3
    assert np.abs(got.weight - want.weight).max() < 1e-3
    # and in the port's default f32, within 0.5 px of the truth
    got32 = matcher.stitching_matcher(img0, img1, device='cpu', **kw)
    err = (got32.xy0 - got32.xy1) - TRUE_T
    assert np.median(np.abs(err), axis=0).max() < 0.5


def test_match_pairs_batched_matches_serial():
    jobs = [(*_pair(s), dict(stage_prior=PRIOR, conf_thresh=0.25))
            for s in (7, 8, 9)]
    batched = matcher.match_pairs_batched(jobs, device='cpu')
    for (img0, img1, kw), m in zip(jobs, batched):
        single = matcher.stitching_matcher(img0, img1, device='cpu', **kw)
        assert m is not None and m.xy0.shape == single.xy0.shape
        assert np.abs(m.xy0 - single.xy0).max() < 1e-3
        assert np.abs(m.xy1 - single.xy1).max() < 1e-3


def _peaks(dev, chunk):
    rng = np.random.default_rng(3)
    big = texture(rng, 600, 600).astype(np.float32)
    offs = rng.integers(0, 500, (128, 2))
    s = rng.integers(-5, 6, (128, 2))
    b0 = np.stack([big[y:y + 64, x:x + 64] for x, y in offs])
    b1 = np.stack([big[y + sy + 10:y + sy + 74, x + sx + 10:x + sx + 74]
                   for (x, y), (sx, sy) in zip(np.clip(offs, 0, 510), s)])
    g0 = masked_dog_filter(torch.from_numpy(b0).to(dev), 2.5)
    g1 = masked_dog_filter(torch.from_numpy(b1).to(dev), 2.5)
    out = []
    for k in range(0, 128, chunk):
        F0 = torch.fft.rfft2(g0[k:k + chunk], s=(128, 128))
        F1 = torch.fft.rfft2(g1[k:k + chunk], s=(128, 128))
        C = torch.fft.irfft2(torch.conj(F0) * F1, s=(128, 128))
        dx, dy, _ = _peak_and_subpixel(C, (128, 128), True)
        out.append(torch.stack([dx, dy], -1).cpu())
    return torch.cat(out).numpy()


def test_fft_batch_8_and_128_give_the_same_peaks():
    # the JAX package chunks at <= 128 because the TPU rfft2 changes
    # precision past that; the port runs the whole stack at once
    assert np.abs(_peaks('cpu', 8) - _peaks('cpu', 128)).max() < 1e-4


@pytest.mark.cuda
def test_fft_batch_parity_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    assert np.abs(_peaks('cuda', 8) - _peaks('cuda', 128)).max() < 1e-4
