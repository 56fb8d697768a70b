"""The readings the thumbnail cell's correctness limit is set from.

    python3 bench_port/thumbnail_proof.py --seeds 11,12,13 --seconds <s>
        [--fault '<name>'] [--tiny]

For each seed, in one process: a run of ``thumbnail.match`` as the
benchmark makes it (set-up, the window, the comparison), then the same
comparison with the control in the program's place on the same units: the
plain reference computed in bfloat16, the nearest precision below the
float32 the program computes in. With ``--fault``, one of ``FAULTS`` is
planted under the timed path after set-up. Prints one JSON line a seed:
the program's numbers and the control's, and the window's units. A limit
lies above the largest program reading over 20 seeds or more and below the
smallest control reading (PERF.md).

``--tiny`` runs at the small sizes of ``shrink``, on the CPU (the tests:
``test_thumbnail_cell.py`` here and ``tests/test_torch_thumbnail_cell.py``).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import harness  # noqa: E402

CELL = 'thumbnail.match'

# The small sizes' limit, set as the cell's own is (PERF.md) from readings
# at these sizes (``--tiny``, CPU, 5 pairs a seed): sound runs 0.24-0.30 px
# (4 seeds), the control 2.73-3.18, the 2 px fault 2.13 (2 seeds).
TINY_LIMIT = 1.5


def shrink(workload, config):
    """The cell at a size a CPU test holds: 4 thumbnails of 768^2 (shifts
    scaled with the side), 1500 features; everything else as the cell."""
    d = config['deployment']
    d.update(thumbnail=768, shift_std=d['shift_std'] * 768 / 4096)
    workload['params']['pool'] = 4
    feat = config['files']['default_thumbnail_configs.yaml']['alignment'][
        'feature_matching']
    feat['detect_settings']['num_features'] = 1500
    workload['limits'] = {'match_err_p95_px': TINY_LIMIT}
    return workload, config


def _shifted(monkeypatch):
    """Each pair's written matches moved by 2 px along x."""
    from feabas_tpu_torch import thumbnail
    orig = thumbnail.match_two_thumbnails_pmcc

    def moved(*a, **k):
        m = orig(*a, **k)
        return None if m is None else type(m)(m.xy0 + [2.0, 0.0], m.xy1,
                                              m.weight, m.strain)
    monkeypatch.setattr(thumbnail, 'match_two_thumbnails_pmcc', moved)


def _coarse(monkeypatch):
    """The PMCC refinement left out: the CLI writes the feature
    stage's coarse matches."""
    from feabas_tpu_torch import thumbnail
    monkeypatch.setattr(thumbnail, 'match_two_thumbnails_pmcc',
                        lambda *a, **k: None)


FAULTS = {'matches moved 2 px on one axis': _shifted,
          'refinement left out: the coarse matches written': _coarse}


def sizes(tiny):
    """(workload, configuration) of the cell, shrunk where ``tiny``."""
    bench = harness.load_json(harness.ROOT, 'BENCHMARK.json')
    entry = next(w for w in bench['workloads'] if w['name'] == CELL)
    wl = harness.load_json(HERE, 'workloads', CELL + '.json')
    conf = harness.load_json(HERE, 'configs', entry['config'] + '.json')
    if tiny:
        shrink(wl, conf)
    return wl, conf


def run(seed, seconds, tiny=False, fault=None, control=True, trace=0):
    """One run of the cell; returns the harness's result with the units'
    pairs and seconds under ``units``."""
    import pytest
    import torch
    if torch.cuda.is_available():
        # the run's own peak, not the process's
        torch.cuda.reset_peak_memory_stats()
    wl, conf = sizes(tiny)
    mp = pytest.MonkeyPatch()
    kw = {'workload': wl, 'config': conf, 'control': control}
    if tiny:
        kw['require_cuda'] = False
    if fault is not None:
        kw['patch'] = lambda state: FAULTS[fault](mp)
    seen = []
    kw['inspect'] = lambda traffic, st, units: seen.extend(
        [u['pair'], round(u['s'], 3)] for u in units if u['ok'])
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=seconds,
                              trace=trace)
    try:
        r = harness.run(args, **kw)
    finally:
        mp.undo()
    r['units'] = seen
    return r


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--fault', default=None, choices=sorted(FAULTS))
    p.add_argument('--tiny', action='store_true')
    a = p.parse_args(argv)
    if a.tiny:
        os.environ.setdefault('FEABAS_TORCH_DEVICE', 'cpu')
    for seed in (int(s) for s in a.seeds.split(',')):
        r = run(seed, a.seconds, a.tiny, a.fault)
        print(json.dumps({
            'seed': seed, 'fault': a.fault, 'correct': r['correct'],
            'attempted': r['attempted'], 'failed': r['failed'],
            'metrics': {k: v['value'] for k, v in r['metrics'].items()},
            'memory_peak_bytes': r['device']['memory_peak_bytes'],
            'program': {k: v['value'] for k, v in r['checks'].items()},
            'control': {k: v['value'] for k, v in r['control_checks'].items()},
            'units': r['units']}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
