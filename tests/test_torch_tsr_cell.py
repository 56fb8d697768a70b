"""The volume renderer as the benchmark's ``align.tsr`` cell drives it, on
the CPU at a small size (``bench_port/tsr_proof.shrink``): the port's
``align_main --mode tsr`` of a seeded aligned pool held against the plain
reference (``bench_port/reference/volume.py``) on the host route (the
CPU's ``device.render: auto``) and on the card route (the plain raster),
the plain reader against the port's store, the control and each planted
fault of ``tsr_proof.FAULTS`` read over a limit, the cell's span and
counter metrics, and the stop of a program with no Lanczos-4 raster."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'bench_port'))

import harness  # noqa: E402
import tsr_proof  # noqa: E402
from reference.volume import read_precomputed  # noqa: E402

from feabas_tpu_torch import _tslite, dal  # noqa: E402
from feabas_tpu_torch import config as pconfig  # noqa: E402

SEED = 2 ** 31 + 4343


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU, asked for by name; the port's config caches start and end
    empty."""
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


def _card_route(conf):
    conf['overrides']['general_configs.yaml']['device'] = {'render': 'true'}


def _run(route, fault=None, control=False, trace=0):
    """One tiny run of the cell, its renders on ``route``."""
    return tsr_proof.run(SEED, 0.5, tiny=True, fault=fault, control=control,
                         trace=trace,
                         config=_card_route if route == 'card' else None)


def _failing(checks):
    return sorted(n for n, c in checks.items() if not c['value'] <= c['limit'])


@pytest.mark.parametrize('route', ['host', 'card'])
def test_sound_run_is_correct_and_the_control_is_not(route):
    r = _run(route, control=True)
    assert r['correct'] and r['failed'] == 0, r['checks']
    cycle = [(0, 0), (256, 0), (0, 256), (256, 256)] * 4
    quads = [tuple(q) for q, _ in r['units']]
    assert quads and quads == cycle[:len(quads)]
    # the card route's plain raster is the reference's arithmetic but for
    # the triangle test; the host route's cv2 sums in fixed point and
    # crops 2 px past each block's source coordinates
    tight = 0.01 if route == 'card' else 0.3
    assert r['checks']['render_err_lsb']['value'] < tight
    assert _failing(r['control_checks']) == ['render_err_local_lsb',
                                             'render_err_lsb']


@pytest.mark.parametrize('fault', sorted(tsr_proof.FAULTS))
def test_fault_under_the_timed_path_is_not_correct(fault):
    r = _run('card', fault=fault)
    assert not r['correct'], (fault, r['checks'])
    assert _failing(r['checks']) == ['render_err_local_lsb',
                                     'render_err_lsb'], r['checks']


@pytest.mark.parametrize('step', sorted(tsr_proof.SOUND))
def test_a_sound_step_reads_under_every_limit(step):
    """What a sound run may differ by (every section sampled one step of
    the 1/32 px snap apart) stays correct, and reads well over a sound
    run."""
    r = _run('card', fault=step)
    assert r['correct'], (step, r['checks'])
    assert r['checks']['render_err_lsb']['value'] > 0.05, r['checks']


def test_a_traced_run_reads_the_cells_span_and_counter_metrics():
    """Every per-layer metric of the cell read from the harness's spans or
    the program's counters reads a number (the roofline needs a card): no
    block rendered on a card here, so ``render.device_pct`` reads 0; each
    px of a layer is decoded from a source tile at least once."""
    bench = harness.load_json(harness.ROOT, 'BENCHMARK.json')
    r = _run('card', trace=1)
    assert r['correct'], r['checks']
    names = [m['name'] for m in bench['per_layer']
             if m['source'] in ('program_span', 'program_counter')
             and tsr_proof.CELL in m.get('workloads', [])]
    assert sorted(names) == ['loader.batched_decode_pct', 'loader.s_mpx',
                             'render.device_pct', 'render.raster_s_mpx',
                             'volume.decoded_per_mpx', 'volume.write_s_mpx']
    for n in names:
        assert isinstance(r['metrics'][n]['value'], float), (n, r['metrics'])
    assert r['metrics']['render.device_pct']['value'] == 0.0
    assert r['metrics']['volume.decoded_per_mpx']['value'] >= 1.0
    assert 'mesh_raster_roofline' not in r['metrics']


def test_the_plain_reader_reads_what_the_store_reads(tmp_path):
    """``read_precomputed`` gives the port's store's read of a volume
    whose chunks are clipped at its end in x, y and z, two of them never
    written."""
    rng = np.random.default_rng(3)
    vol = rng.integers(0, 256, (75, 61, 7), dtype=np.uint8)
    path = str(tmp_path / 'v')
    spec = {'driver': 'neuroglancer_precomputed',
            'kvstore': {'driver': 'file', 'path': path},
            'scale_metadata': {'size': [75, 61, 7], 'chunk_size': [32, 32, 4],
                               'resolution': [4, 4, 30], 'encoding': 'raw'},
            'multiscale_metadata': {'data_type': 'uint8', 'num_channels': 1,
                                    'type': 'image'},
            'create': True, 'open': True}
    store = _tslite.open(spec).result()
    store[0:64, :, :, 0] = vol[0:64]
    store[64:75, 0:32, :, 0] = vol[64:75, 0:32]
    got = read_precomputed(path)
    want = store.read().result()
    assert np.array_equal(got['data'], want.transpose(3, 2, 1, 0))
    assert got['present'].shape == (2, 2, 3) and got['present'].sum() == 10
    assert not got['present'][:, 1, 2].any()
    os.truncate(os.path.join(path, '4_4_30', '0-32_0-32_0-4'), 100)
    with pytest.raises(ValueError, match='voxels'):
        read_precomputed(path)


def test_a_program_with_no_lanczos_raster_stops_before_the_inputs(
        monkeypatch):
    """A program whose raster has only the bilinear mode would render the
    cell's LANCZOS on the host and leave the card idle: the set-up exits
    non-zero before it writes the pool."""
    from feabas_tpu_torch.ops import render as ops_render
    monkeypatch.setattr(ops_render, 'INTERPS', ('linear',))
    traffic = harness.load_module('traffic', 'align_tsr')
    made = []
    monkeypatch.setattr(traffic.align_pool, 'write_pool',
                        lambda *a: made.append(a))
    with pytest.raises(SystemExit, match='no Lanczos-4 mode'):
        _run('card')
    assert made == []


def test_the_cell_writes_through_the_ports_store(monkeypatch):
    """Where tensorstore is installed the port binds it; the cell's host
    has none, so its volumes go through ``_tslite``: the cell reads
    correct with ``_tslite`` bound here too."""
    monkeypatch.setattr(dal, 'ts', _tslite)
    r = _run('card')
    assert r['correct'], r['checks']
