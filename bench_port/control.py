"""The readings the correctness limits are set from, on the chip.

    python3 bench_port/control.py --workload <cell> --seeds 11,12,13 --seconds <s>
        [--fault '<name>'] [--dump <dir>] [--tiny]

For each seed, in one process: a run of the cell as the benchmark makes it
(set-up, the window, the comparison), then the same comparison with the
control in the program's place on the same units: the plain reference
computed in bfloat16, the nearest precision below the float32 the program
computes in. With ``--fault``, the named fault of ``test_correct.py`` is
planted under the timed path after set-up (one of the cell's). Prints one
JSON line a seed: the program's numbers and the control's (each unit's
seconds go to standard error). A limit lies above the largest program reading over a dozen seeds
or more and below the smallest control reading (PERF.md).

``--dump`` writes, a seed, the raw material of the numbers compared, for
the program and the control, to ``<dir>/<cell>.<seed>.npz``: align.match
each pair's grid of error vectors (mip-0 px) and the true displacement at
its points; stitch.section, for each compared block, the
histogram of |difference| and its sums over squares of 64 to 512 px.
``--tiny`` runs at the small sizes of ``tiny_sizes.py``, on the CPU.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness  # noqa: E402

SIDES = (64, 128, 256, 512)


def _align_dump(traffic, st, units):
    from reference.align import truth_xy0
    out = {}
    for u in units:
        if not u['ok']:
            continue
        for tag, control in (('program', False), ('control', True)):
            _, at_q, q = traffic._errors(st, u, control)
            t = truth_xy0(st.d, st.drift, u['pair'], u['pair'] + 1, q,
                          st.scale).numpy()
            key = f'{tag}.u{u["index"]}.p{u["pair"]}'
            out[key + '.vec'] = at_q
            out[key + '.true'] = st.scale * (t - q)
    return out


def _stitch_dump(traffic, st, units):
    import torch
    ok = [u for u in units if u['ok']]
    out = {}
    for n in sorted(traffic.render_sample(st, ok)):
        u = ok[n]
        for tag, control in (('program', False), ('control', True)):
            g, _ = traffic.canvas_offset(st, u, control)
            for b, (diff, seen) in enumerate(
                    traffic._render_diffs(st, u, g, control)):
                key = f'{tag}.u{u["index"]}.b{b}'
                v = torch.round(diff[seen]).clamp(0, 255).long()
                out[key + '.hist'] = torch.bincount(
                    v, minlength=256).cpu().numpy()
                for side in SIDES:
                    d, c = traffic.square_sums(diff, seen, side)
                    out[f'{key}.s{side}'] = torch.stack([d, c]).cpu().numpy(
                    ).astype(np.float32)
    return out


DUMPS = {'align_pairs': _align_dump, 'stitch_sections': _stitch_dump}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--fault', default=None)
    p.add_argument('--dump', default=None)
    p.add_argument('--tiny', action='store_true')
    a = p.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(',')):
        args = argparse.Namespace(workload=a.workload, seed=seed,
                                  seconds=a.seconds, trace=0)
        kw = {'control': True}
        if a.tiny:
            import tiny_sizes
            entry = next(w for w in harness.load_json(
                harness.ROOT, 'BENCHMARK.json')['workloads']
                if w['name'] == a.workload)
            wl = harness.load_json(HERE, 'workloads', a.workload + '.json')
            conf = harness.load_json(HERE, 'configs', entry['config'] + '.json')
            tiny_sizes.shrink(a.workload, wl, conf)
            kw.update(require_cuda=False, workload=wl, config=conf)
        mp = None
        if a.fault:
            import pytest
            import test_correct
            mp = pytest.MonkeyPatch()
            plant = test_correct.FAULTS[a.workload, a.fault]
            kw['patch'] = lambda state: plant(mp)
        dumped = {}
        if a.dump:
            def inspect(traffic, st, units):
                dumped.update(DUMPS[st.cell.entry['traffic']](traffic, st,
                                                                units))
            kw['inspect'] = inspect
        try:
            r = harness.run(args, **kw)
        finally:
            if mp is not None:
                mp.undo()
        if a.dump:
            os.makedirs(a.dump, exist_ok=True)
            tag = '' if not a.fault else '.fault-' + ''.join(
                ch if ch.isalnum() else '_' for ch in a.fault)[:40]
            np.savez_compressed(os.path.join(
                a.dump, f'{a.workload}.{seed}{tag}.npz'), **dumped)
        print(json.dumps({'seed': seed, 'fault': a.fault,
                          'correct': r['correct'],
                          'attempted': r['attempted'], 'failed': r['failed'],
                          'metrics': {k: v['value'] for k, v in r['metrics'].items()},
                          'program': {k: v['value'] for k, v in r['checks'].items()},
                          'control': {k: v['value'] for k, v in
                                      r['control_checks'].items()}}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
