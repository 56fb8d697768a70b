"""The thumbnail cell's comparison shown to fail, and its traced run, on
the CPU.

    FEABAS_TORCH_DEVICE=cpu python3 -m pytest \
        bench_port/test_thumbnail_cell.py -q

Each case drives the rest of a run of ``thumbnail.match`` (set-up, window,
the comparison), past the harness's look for a card and at the small
sizes of ``thumbnail_proof.shrink``: a sound run must come out correct;
the control (the plain reference in bfloat16 in the program's place) and
each fault of ``thumbnail_proof.FAULTS`` planted under the timed path must
come out not correct. The readings at the cell's own size come from
``thumbnail_proof.py`` on the chip (PERF.md).
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness  # noqa: E402
import thumbnail_proof  # noqa: E402

SEED = 2 ** 31 + 8765


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')


def _failing(checks):
    return sorted(n for n, c in checks.items() if not c['value'] <= c['limit'])


def test_sound_run_is_correct_and_the_control_is_not():
    r = thumbnail_proof.run(SEED, 1.0, tiny=True)
    assert r['correct'], r['checks']
    assert r['attempted'] >= 1 and r['failed'] == 0
    assert _failing(r['control_checks']), r['control_checks']


@pytest.mark.parametrize('fault', sorted(thumbnail_proof.FAULTS))
def test_fault_under_the_timed_path_is_not_correct(fault):
    r = thumbnail_proof.run(SEED, 1.0, tiny=True, fault=fault,
                            control=False)
    assert not r['correct'], (fault, r['checks'])
    assert _failing(r['checks']) or r['failed'], r['checks']


def test_a_traced_run_reads_the_cells_span_and_counter_metrics():
    """Every per-layer metric of the cell read from the harness's spans or
    the program's counters reads a number (the rooflines need a card)."""
    bench = harness.load_json(harness.ROOT, 'BENCHMARK.json')
    r = thumbnail_proof.run(SEED, 1.0, tiny=True, control=False, trace=1)
    assert r['correct'], r['checks']
    names = [m['name'] for m in bench['per_layer']
             if m['source'] in ('program_span', 'program_counter')
             and thumbnail_proof.CELL in m.get('workloads', [])]
    assert len(names) == 4
    for n in names:
        assert isinstance(r['metrics'][n]['value'], float), (n, r['metrics'])
