"""A traced run of each cell reads the program's counters, on the CPU.

    FEABAS_TORCH_DEVICE=cpu python3 -m pytest bench_port/test_trace.py -q

Each case drives a ``--trace 1`` run of a cell past the harness's look for
a card, at the small sizes of ``tiny_sizes.py``: every per-layer metric
read from the program's counters (``source`` ``program_counter``) that
lists the cell must read a number, and the run must be correct.
"""

import argparse
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness  # noqa: E402
import tiny_sizes  # noqa: E402

SEED = 2 ** 31 + 1234


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')


@pytest.mark.parametrize('cell', ('align.match', 'stitch.section'))
def test_a_traced_run_reads_the_program_counters(cell):
    bench = harness.load_json(harness.ROOT, 'BENCHMARK.json')
    wl = harness.load_json(HERE, 'workloads', cell + '.json')
    entry = next(w for w in bench['workloads'] if w['name'] == cell)
    conf = harness.load_json(HERE, 'configs', entry['config'] + '.json')
    tiny_sizes.shrink(cell, wl, conf)
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=1.0, trace=1)
    r = harness.run(args, require_cuda=False, workload=wl, config=conf)
    assert r['correct'], r['checks']
    names = [m['name'] for m in bench['per_layer']
             if m['source'] == 'program_counter'
             and cell in m.get('workloads', [cell])]
    assert names
    for n in names:
        assert isinstance(r['metrics'][n]['value'], float), (n, r['metrics'])
