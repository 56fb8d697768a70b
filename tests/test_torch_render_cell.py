"""The mesh renderer as the benchmark's ``align.render`` cell drives it, on
the CPU at a small size (``bench_port/render_proof.shrink``): the port's
``align_main --mode rendering`` of a seeded aligned pool held against the
plain reference (``bench_port/reference/render.py``) on the host route
(the CPU's ``device.render: auto``) and on the card route (the plain
raster), the control and each planted fault of ``render_proof.FAULTS``
read over a limit, the cell's span and counter metrics, the stop of a
program with no Lanczos-4 raster, and the raster's roofline count against
a hand count."""

import argparse
import math
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'bench_port'))

import harness  # noqa: E402
import render_proof  # noqa: E402

from feabas_tpu_torch import config as pconfig  # noqa: E402

SEED = 2 ** 31 + 4242
PK = {'float32_flops': 67e12, 'bytes': 3.35e12}   # roofline/peaks.json's


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU, asked for by name; the port's config caches start and end
    empty."""
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


def _run(route, fault=None, control=False, trace=0, seconds=0.5):
    """One tiny run of the cell, its renders on ``route``."""
    wl, conf = render_proof.sizes(tiny=True)
    if route == 'card':
        conf['overrides']['general_configs.yaml']['device'] = {
            'render': 'true'}
    kw = {}
    mp = pytest.MonkeyPatch()
    if fault is not None:
        plant = {**render_proof.FAULTS, **render_proof.SOUND}[fault]
        kw['patch'] = lambda st: plant(st, mp)
    args = argparse.Namespace(workload=render_proof.CELL, seed=SEED,
                              seconds=seconds, trace=trace)
    try:
        return harness.run(args, require_cuda=False, workload=wl,
                           config=conf, control=control, **kw)
    finally:
        mp.undo()


def _failing(checks):
    return sorted(n for n, c in checks.items() if not c['value'] <= c['limit'])


@pytest.mark.parametrize('route', ['host', 'card'])
def test_sound_run_is_correct_and_the_control_is_not(route):
    r = _run(route, control=True)
    assert r['correct'] and r['failed'] == 0, r['checks']
    assert r['attempted'] >= 1
    # the card route's plain raster is the reference's arithmetic but for
    # the triangle test; the host route's cv2 sums in fixed point and
    # crops 2 px past each block's source coordinates
    tight = 0.01 if route == 'card' else 0.2
    assert r['checks']['render_err_lsb']['value'] < tight
    assert _failing(r['control_checks']) == ['render_err_local_lsb',
                                             'render_err_lsb']


@pytest.mark.parametrize('fault', sorted(render_proof.FAULTS))
def test_fault_under_the_timed_path_is_not_correct(fault):
    r = _run('card', fault=fault)
    assert not r['correct'], (fault, r['checks'])
    assert 'render_err_local_lsb' in _failing(r['checks']), r['checks']


@pytest.mark.parametrize('step', sorted(render_proof.SOUND))
def test_a_sound_step_reads_under_every_limit(step):
    """What a sound run may differ by (a whole section sampled one step of
    the 1/32 px snap apart on both axes) stays correct, and reads well over
    a sound run."""
    r = _run('card', fault=step)
    assert r['correct'], (step, r['checks'])
    assert r['checks']['render_err_lsb']['value'] > 0.05, r['checks']


def test_a_traced_run_reads_the_cells_span_and_counter_metrics():
    """Every per-layer metric of the cell read from the harness's spans or
    the program's counters reads a number (the roofline needs a card): no
    block rendered on a card here, so ``render.device_pct`` reads 0."""
    bench = harness.load_json(harness.ROOT, 'BENCHMARK.json')
    r = _run('card', trace=1)
    assert r['correct'], r['checks']
    names = [m['name'] for m in bench['per_layer']
             if m['source'] in ('program_span', 'program_counter')
             and render_proof.CELL in m.get('workloads', [])]
    assert sorted(names) == ['loader.batched_decode_pct',
                             'loader.cache_hit_pct', 'loader.meta_decode_pct',
                             'loader.s_mpx', 'render.batched_encode_pct',
                             'render.device_pct', 'render.encode_s_mpx',
                             'render.raster_s_mpx']
    for n in names:
        assert isinstance(r['metrics'][n]['value'], float), (n, r['metrics'])
    assert r['metrics']['render.device_pct']['value'] == 0.0
    assert 'mesh_raster_roofline' not in r['metrics']


def test_a_program_with_no_lanczos_raster_stops_before_the_inputs(
        monkeypatch):
    """A program whose raster has only the bilinear mode would render the
    cell's LANCZOS on the host and leave the card idle: the set-up exits
    non-zero before it writes the pool."""
    from feabas_tpu_torch.ops import render as ops_render
    monkeypatch.setattr(ops_render, 'INTERPS', ('linear',))
    traffic = harness.load_module('traffic', 'align_render')
    made = []
    monkeypatch.setattr(traffic.align_pool, 'write_pool',
                        lambda *a: made.append(a))
    with pytest.raises(SystemExit, match='no Lanczos-4 mode'):
        _run('card')
    assert made == []


@pytest.mark.parametrize('interp', ['linear', 'lanczos4'])
@pytest.mark.parametrize('shared', [False, True])
def test_roofline_count_equals_a_hand_count(interp, shared):
    """Two 128 x 256 blocks, u8 out, each with a 300 x 400 crop of its own
    (or one shared 1000 x 1000 source), a (2, 16, 14) table and (2, 2, 4)
    cell candidates: per px 14 FLOP for the coordinate and its snap, then
    12 (bilinear) or 144 (Lanczos-4); bytes: the output, the crops (of the
    shared source, a window of h + taps - 1 by w + taps - 1 a block), the
    table and the candidates."""
    mod = harness.load_module('roofline', 'mesh_raster')
    src = torch.zeros((1000, 1000) if shared else (2, 300, 400),
                      dtype=torch.uint8)
    tables = torch.zeros((2, 16, 14))
    cands = torch.zeros((2, 2, 4), dtype=torch.int32)
    px = 2 * 128 * 256
    taps = 8 if interp == 'lanczos4' else 2
    src_bytes = 2 * (128 + taps - 1) * (256 + taps - 1) if shared \
        else 2 * 300 * 400
    flop = px * (14 + (144 if interp == 'lanczos4' else 12))
    nbytes = px + src_bytes + 4 * 2 * 16 * 14 + 4 * 2 * 2 * 4
    got = mod.call_bound(PK, src, tables, cands, 128, 256, 'u8', interp)
    assert math.isclose(got, max(flop / 67e12, nbytes / 3.35e12),
                        rel_tol=1e-12)


def test_the_roofline_wrapper_records_card_calls_only():
    """On the CPU the wrapped ``raster_blocks`` is the program's own call,
    recording nothing."""
    mod = harness.load_module('roofline', 'mesh_raster')
    seen = []

    def record(*a, **k):
        seen.append(a)

    def orig(*a, **k):
        return ('orig', a, k)
    wrapped = mod.wrap(orig, record)
    tables = torch.zeros((1, 8, 14))
    out = wrapped(None, tables, None, 0.0, 8, 8, False, 'u8',
                  interp='lanczos4')
    assert out[0] == 'orig' and out[2] == {'interp': 'lanczos4'} and not seen
