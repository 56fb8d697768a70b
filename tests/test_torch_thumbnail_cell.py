"""The thumbnail matcher as the benchmark's ``thumbnail.match`` cell drives
it, on the CPU at a small size: the port's ``thumbnail_main`` matching of a
seeded turned pool held against the plain reference
(``bench_port/reference/thumbnail.py``), a 2 px match fault read over the
limit, the thumbnail stage's spans and counters, and the cell's roofline
counts against ``chip_smoke.py``'s hand count. The kernels' launches are
linked to the ``launch`` span on the card (``cuda``)."""

import argparse
import ast
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, 'bench_port')
sys.path.insert(0, BENCH)

import harness  # noqa: E402
import thumbnail_proof  # noqa: E402
from inputs import thumb_stack  # noqa: E402
from reference.thumbnail import truth_xy0  # noqa: E402

from feabas_tpu_torch import config as pconfig  # noqa: E402
from feabas_tpu_torch import thumbnail, trace  # noqa: E402

SEED = 2 ** 31 + 2718
PK = {'float32_flops': 67e12, 'bytes': 3.35e12}   # chip_smoke.py's peaks


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU, asked for by name; the port's config caches start and end
    empty."""
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


def _shift_files(traffic, st, units):
    """Each match file of the window rewritten with its matches moved by
    2 px along x; returns the comparison of the moved files."""
    from feabas_tpu_torch.aligner import (read_matches_from_h5,
                                          save_matches_to_h5)
    res = float(st.d['resolution_nm'] * 2 ** st.d['thumbnail_mip_level'])
    for u in units:
        if u['ok']:
            m = read_matches_from_h5(u['file'], target_resolution=res)
            save_matches_to_h5(u['file'], type(m)(m.xy0 + [2.0, 0.0], m.xy1,
                                                 m.weight, m.strain), res)
    return traffic.check(st, units)


def test_matching_of_a_turned_pool_is_held_against_the_reference():
    """A traced run of the cell at its small size: correct against the
    reference; the reference in bfloat16 and the window's match files
    moved by 2 px both read over the limit; the span and counter metrics
    read numbers."""
    wl, conf = thumbnail_proof.sizes(tiny=True)
    wl['params']['pool'] = 3
    moved = []
    args = argparse.Namespace(workload=thumbnail_proof.CELL, seed=SEED,
                              seconds=0.5, trace=1)
    r = harness.run(args, require_cuda=False, workload=wl, config=conf,
                    control=True, inspect=lambda *a: moved.extend(
                        _shift_files(*a)))
    limit = wl['limits']['match_err_p95_px']
    assert r['correct'] and r['failed'] == 0, r['checks']
    assert r['checks']['match_err_p95_px']['value'] < limit / 3
    assert r['control_checks']['match_err_p95_px']['value'] > limit
    (name, value, lim), = moved
    assert value > lim and value > 2.0 - r['checks'][name]['value']
    for n in ('thumbnail.features_s_pair', 'thumbnail.match_s_pair',
              'thumbnail.refine_s_pair', 'thumbnail.ransac_trials'):
        assert isinstance(r['metrics'][n]['value'], float), (n, r['metrics'])


def _pair(size=320):
    """Two thumbnails of the cell's kind (turned by about 30 degrees) and
    their motions."""
    d = dict(thumbnail_proof.sizes(tiny=False)[1]['deployment'],
             thumbnail=size, shift_std=8.0)
    angles, shifts = thumb_stack.motions(d, 2, SEED)
    imgs = thumb_stack.sections(torch.device('cpu'), d, angles, shifts,
                                SEED + 1)
    return imgs, angles, shifts


def test_the_thumbnail_stage_opens_its_spans_and_moves_its_counters():
    imgs, angles, shifts = _pair()
    conf = thumbnail_proof.sizes(tiny=False)[1]
    fm = conf['files']['default_thumbnail_configs.yaml']['alignment'][
        'feature_matching']
    fm['detect_settings']['num_features'] = 600
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kps = [thumbnail.prepare_image(img, **fm) for img in imgs]
        match, coarse = thumbnail.align_two_thumbnails(
            imgs[0], imgs[1], return_coarse=True,
            feature_matching=dict(fm, kps0=kps[0], kps1=kps[1]),
            block_matching={'spacings': [60, 30]})
        ransac = thumbnail.filter_match_global_ransac(coarse.xy0, coarse.xy1)
        keep = thumbnail.verify_match_elastic(
            coarse.xy0[:8], coarse.xy1[:8], coarse.weight[:8],
            (coarse.xy0, coarse.xy1, coarse.weight), imgs[0].shape,
            imgs[1].shape)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    for span in ('features', 'feature_match', 'ransac', 'subpixel', 'verify',
                 'refine'):
        assert trace.PREFIX + 'thumbnail.' + span in names, span
    c = trace.counters()
    assert c['thumbnail.keypoints'] == kps[0].num_points + kps[1].num_points
    assert c['thumbnail.match_rounds'] >= 1
    assert c['thumbnail.ransac_calls'] >= 2
    assert c['thumbnail.ransac_trials'] >= c['thumbnail.ransac_calls']
    assert c['thumbnail.coarse_matches'] == coarse.xy0.shape[0]
    assert c['thumbnail.refined_matches'] == match.xy0.shape[0]
    assert ransac[0].sum() >= 3 and keep.sum() >= 3
    err = np.linalg.norm(match.xy0 - truth_xy0(
        320, angles, shifts, 0, 1, match.xy1).numpy(), axis=1)
    assert np.median(err) < 0.5


def _roofline(name):
    return harness.load_module('roofline', name)


@pytest.mark.parametrize('kernel', ['peak_detect', 'lradon_patch',
                                    'lradon_match'])
def test_roofline_count_equals_chip_smokes_hand_count(kernel):
    """At one shape each (the patch windows cover the whole image; every
    row kept by the masks), the benchmark's bound of a call equals
    ``chip_smoke._lradon_bound``'s."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from feabas_tpu_torch.ops import lradon
    mod = _roofline(kernel)
    g = torch.Generator().manual_seed(SEED)
    if kernel == 'peak_detect':
        f = torch.randn((96, 80), generator=g)
        mask = torch.ones_like(f)
        args = (f, mask, 10)
        got = mod.call_bound(PK, f.numel(), 10, True)
    elif kernel == 'lradon_patch':
        D, offs, Rp = lradon._desc_params(6, 8, 3, 15)
        tables = lradon._stencil_tensors(6, 8, 3, D, offs, Rp,
                                         torch.device('cpu'))
        img = torch.rand((40, 36), generator=g)
        z = torch.randint(Rp + 1, Rp + 30, (64, 2), generator=g,
                          dtype=torch.int32)
        z[0] = Rp + 1              # a window from the image's corner
        f = torch.rand((64, 2), generator=g)
        args = (img, z, f, tables, 6, Rp)
        assert mod.window_pixels(40, 36, z, Rp) == img.numel()
        got = mod.call_bound(PK, 40, 36, z, tables[0], Rp)
    else:
        d0 = torch.randn((192, 6, 8), generator=g)
        d1 = torch.randn((128, 6, 8), generator=g)
        v0 = torch.ones(192, dtype=torch.bool)
        v1 = torch.ones(128, dtype=torch.bool)
        args = (d0, v0, d1, v1, 6, True)
        got = mod.call_bound(PK, 192, 128, 192, 128, 48, 12)
    want, _ = chip_smoke._lradon_bound(kernel, args)
    assert got == pytest.approx(want, rel=1e-12)


def test_the_patch_bound_counts_each_window_pixel_once():
    mod = _roofline('lradon_patch')
    Rp = 2                         # windows of 2 Rp + 2 = 6 px a side
    z = torch.tensor([[Rp + 1, Rp + 1], [Rp + 1, Rp + 1], [Rp + 4, Rp + 1],
                      [-50, -50]], dtype=torch.int32)
    # [0, 6) x [0, 6), again, [3, 9) x [0, 6), and the corner pixel
    # clamped reads reach from far outside the image
    assert mod.window_pixels(20, 20, z, Rp) == 6 * 9
    z = torch.tensor([[-50, -50]], dtype=torch.int32)
    assert mod.window_pixels(20, 20, z, Rp) == 1


def test_the_thumbnail_kernels_launch_through_launch_on():
    """K15-K17 launch inside ``device.launch_on``'s ``launch`` span, so a
    profiler links each launch to a range that starts at the launch and
    not to the thumbnail span open around it (which would take the
    launch out of the benchmark's kernel range)."""
    src = open(os.path.join(REPO, 'feabas_tpu_torch', 'ops',
                            'lradon.py')).read()
    launched = set()
    for node in ast.walk(ast.parse(src)):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr.endswith('_f32'):
            raise AssertionError(f'{node.func.attr} called outside launch_on')
        if getattr(node.func, 'attr', '') == 'launch_on':
            launched.add(node.args[1].attr)
    assert launched == {'peak_detect_f32', 'lradon_patch_f32',
                        'lradon_match_f32'}


@pytest.mark.cuda
def test_thumbnail_kernels_are_linked_to_the_launch_span_on_the_card():
    """On the card: each of K15-K17, called inside a thumbnail span and a
    caller's range (as the benchmark's kernel ranges wrap it), is linked
    to the ``launch`` span, which starts inside the caller's range."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    from feabas_tpu_torch.ops import lradon
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(SEED)
    f = torch.randn((256, 256), generator=g, device=dev)
    D, offs, Rp = lradon._desc_params(6, 8, 3, 15)
    tables = lradon._stencil_tensors(6, 8, 3, D, offs, Rp, dev)
    z = torch.randint(Rp + 1, 200, (64, 2), generator=g, device=dev,
                      dtype=torch.int32)
    fr = torch.rand((64, 2), generator=g, device=dev)
    d = torch.randn((128, 6, 8), generator=g, device=dev)
    v = torch.ones(128, dtype=torch.bool, device=dev)
    calls = {'peak_kernel': lambda: lradon.peak_response(f, None, 10),
             'patch_kernel': lambda: lradon.lradon_patch(f, z, fr, tables, 6,
                                                         Rp),
             'variant_max_kernel': lambda: lradon.lradon_match(d, v, d, v, 6)}
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    for kernel, call in calls.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with trace.span('thumbnail.features'):
                with torch.profiler.record_function('caller'):
                    call()
                torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        host = {}
        for e in events:
            if 'CPU' in str(e.device_type()):
                host.setdefault(e.correlation_id(), []).append(e)
        caller, = [e for e in events if e.name() == 'caller'
                   and 'CPU' in str(e.device_type())]
        kernels = [e for e in events if 'CPU' not in str(e.device_type())
                   and kernel in e.name()]
        assert kernels, (kernel, sorted({e.name()[:60] for e in events}))
        for k in kernels:
            linked = host.get(k.linked_correlation_id(), [])
            ours = [h for h in linked if h.name().startswith(trace.PREFIX)]
            assert [h.name() for h in ours] == [trace.PREFIX + 'launch'], \
                (kernel, [h.name() for h in linked])
            assert caller.start_ns() <= ours[0].start_ns() \
                <= caller.start_ns() + caller.duration_ns()
