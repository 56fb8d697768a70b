"""A traced window of a cell, read with the program's own spans and
counters beside the benchmark's.

    python3 bench_port/breakdown.py --workload <cell> --seeds 11,12 --seconds <s> [--tiny]

The benchmark's traced run (``run.py --trace 1``) reads its own ranges
(``bench.*``) alone and leaves the program's counters as the process
left them. Here, in the same run: the program's counters are zeroed when
set-up ends and read when the window ends, and the profiler's events are
read again with the program's ``feabas.*`` host ranges added to the spans
that label the card's idle gaps (the innermost open range, as
``profiling.py`` labels them). Prints one JSON line a seed: the run's
result as the harness gives it, the idle seconds by program span, the
seconds inside each program span, the window's counters, and, over the
window's Mpx: decode and encode seconds, decoded Mpx, the loaders' cache
hit share and the CG trips a solve. ``--tiny`` runs at the small sizes of
``tiny_sizes.py``, on the CPU.
"""

import argparse
import json
import os
import sys
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness  # noqa: E402
import profiling  # noqa: E402
import tiny_sizes  # noqa: E402

PROGRAM = 'feabas.'


def program_reading(events):
    """(idle seconds by innermost span, program span seconds) of the
    window in ``events``: the benchmark's spans and units and the
    program's ranges label the gaps between device work."""
    t0 = t1 = None
    spans, program, dev = [], defaultdict(list), []
    for e in events:
        name = e.name()
        s = e.start_ns()
        iv = (s, s + e.duration_ns())
        if 'CPU' in str(e.device_type()):
            if name == profiling.WINDOW:
                t0, t1 = iv
            elif name.startswith(profiling.SPAN):
                spans.append(iv + (name[len(profiling.SPAN):],))
            elif name == profiling.UNIT:
                spans.append(iv + ('unit',))
            elif name.startswith(PROGRAM):
                program[name[len(PROGRAM):]].append(iv)
        elif not name.startswith(('bench.', PROGRAM)):
            dev.append(iv)
    dev = [(max(s, t0), min(e, t1)) for s, e in dev if e > t0 and s < t1]
    gaps, prev = [], t0
    for s, e in profiling._merged(dev) + [[t1, t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    # each kernel launch's own range holds no host time worth a label, and
    # thousands of them would slow the segmentation
    labelled = spans + [iv + (n,) for n, ivs in program.items() for iv in ivs
                        if n != 'launch']
    idle = profiling._idle_by_label(gaps, profiling._segments(labelled, t0, t1))
    inside = {n: sum(min(e, t1) - max(s, t0)
                     for s, e in profiling._merged(ivs) if e > t0 and s < t1) / 1e9
              for n, ivs in program.items()}
    return (sorted(idle.items(), key=lambda kv: -kv[1]),
            dict(sorted(inside.items(), key=lambda kv: -kv[1])))


def per_mpx(inside, counts, mpx):
    def ratio(a, b):
        return a / b if b else None
    return {
        'loader.decode_s_mpx': ratio(inside.get('loader.decode', 0.0), mpx),
        'loader.decoded_per_mpx': ratio(counts.get('loader.decoded_px', 0) / 1e6,
                                        mpx),
        'loader.cache_hit_pct': ratio(100.0 * counts.get('loader.cache_hits', 0),
                                      counts.get('loader.cache_lookups', 0)),
        'blender.encode_s_mpx': ratio(inside.get('blender.encode', 0.0), mpx),
        'solver.cg_iters': ratio(counts.get('solver.cg_iters', 0),
                                 counts.get('solver.cg_calls', 0)),
    }


def one_run(cell, seed, seconds, tiny):
    from feabas_tpu_torch import trace
    wl = conf = None
    if tiny:
        entry = next(w for w in harness.load_json(
            harness.ROOT, 'BENCHMARK.json')['workloads'] if w['name'] == cell)
        wl = harness.load_json(HERE, 'workloads', cell + '.json')
        conf = harness.load_json(HERE, 'configs', entry['config'] + '.json')
        tiny_sizes.shrink(cell, wl, conf)
    got = {}
    digest = profiling.digest

    def reading(events, bounds, names):
        got['counters'] = trace.counters()
        events = list(events)
        got['idle'], got['inside'] = program_reading(events)
        return digest(events, bounds, names)

    def window_units(traffic, state, units):
        got['units'] = units
    profiling.digest = reading
    try:
        args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                                  trace=1)
        r = harness.run(args, require_cuda=not tiny, workload=wl, config=conf,
                        patch=lambda state: trace.reset_counters(),
                        inspect=window_units)
    finally:
        profiling.digest = digest
    mpx = sum(u['mpx'] for u in got['units'] if u['ok'])
    return {'seed': seed, 'result': r, 'mpx': mpx,
            'unit_s': [u['s'] for u in got['units']],
            'idle_by_program_span': got['idle'],
            'program_span_s': got['inside'], 'counters': got['counters'],
            'per_mpx': per_mpx(got['inside'], got['counters'], mpx)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--tiny', action='store_true')
    a = p.parse_args(argv)
    if a.tiny:
        os.environ.setdefault('FEABAS_TORCH_DEVICE', 'cpu')
    for seed in (int(s) for s in a.seeds.split(',')):
        print(json.dumps(one_run(a.workload, seed, a.seconds, a.tiny)),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
