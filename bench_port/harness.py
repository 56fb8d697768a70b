"""One run of one cell of the port's benchmark.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name: ``BENCHMARK.json`` names its configuration and
traffic; ``workloads/<cell>.json`` holds the traffic's parameters and the
correctness limits, ``configs/<config>.json`` the deployment and the
driver configuration as run, ``traffic/<kind>.py`` the code that makes the
inputs and drives one unit of work through the port's CLI drivers. The
per-layer metrics are ``metrics/<metric>.py`` readers of the traced
window; the kernel rooflines' work counts are ``roofline/<kernel>.py``.

A run: set-up (imports, CUDA, inputs made on the card from the seed and
written as the drivers read them, one untimed unit), then units of work
one after another until ``--seconds`` have passed (the unit in flight
finishes, and the window ends with it), then the comparison of what the
window's units wrote with the plain reference, then one JSON line.
"""

import argparse
import gc
import importlib.util
import json
import os
import re
import shutil
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# work dirs and caches of a run: fixed paths inside the checkout
RUN_DIR = os.path.join(HERE, '_run')
FORBIDDEN = ('jax', 'feabas_tpu', 'chip_smoke', 'bench')
# the program under test: the port's package at the checkout's root
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind, name):
    """``<kind>/<name>.py`` under the benchmark's folder, by file name."""
    path = os.path.join(HERE, kind, name + '.py')
    spec = importlib.util.spec_from_file_location(f'bench_{kind}_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Cell:
    """What a traffic module is given: the cell's entries and files, the
    seed, the device, and a work dir of its own."""

    def __init__(self, name, seed, dev, entry, workload=None, config=None):
        self.name = name
        self.entry = entry
        self.workload = workload or load_json(HERE, 'workloads', name + '.json')
        self.config = config or load_json(HERE, 'configs',
                                          entry['config'] + '.json')
        self.seed = seed
        self.dev = dev
        self.work = os.path.join(RUN_DIR, 'work', name)


class Recorder:
    """The traced run's kernel ranges: ``record(kernel, bound, fn, *args)``
    runs ``fn`` inside ``bench.kernel.<kernel>`` and keeps the call's bound
    (seconds, or a function that gives them after the window)."""

    def __init__(self, peaks):
        self.peaks = peaks
        self.bounds = {}
        self.names = {}

    def __call__(self, kernel, b, fn, *args, **kwargs):
        import torch
        self.bounds.setdefault(kernel, []).append(b)
        with torch.profiler.record_function('bench.kernel.' + kernel):
            return fn(*args, **kwargs)

    def resolved(self):
        return {k: [b() if callable(b) else b for b in v]
                for k, v in self.bounds.items()}


class Patches:
    """Wrappers put on the program's functions for the traced run, and
    taken off again."""

    def __init__(self):
        self.saved = []

    def put(self, owner, attr, wrapper):
        orig = getattr(owner, attr)
        self.saved.append((owner, attr, orig))
        setattr(owner, attr, wrapper(orig))

    def span(self, owner, attr, layer, sync):
        import torch

        def wrapper(orig):
            def spanned(*args, **kwargs):
                with torch.profiler.record_function('bench.span.' + layer):
                    out = orig(*args, **kwargs)
                    if sync:
                        torch.cuda.synchronize()
                return out
            return spanned
        self.put(owner, attr, wrapper)

    def restore(self):
        for owner, attr, orig in reversed(self.saved):
            setattr(owner, attr, orig)
        self.saved = []


def install_tracing(traffic, state, recorder, sync):
    """Spans around the layers the traffic names, and a kernel range
    around each call of every kernel that ``roofline/`` counts."""
    patches = Patches()
    for owner, attr, layer in traffic.spans(state):
        patches.span(owner, attr, layer, sync)
    if recorder.peaks is not None:
        for fn in sorted(os.listdir(os.path.join(HERE, 'roofline'))):
            if not fn.endswith('.py'):
                continue
            mod = load_module('roofline', fn[:-3])
            if not hasattr(mod, 'MODULE'):
                continue
            owner = importlib.import_module(mod.MODULE)
            recorder.names[mod.KERNEL] = re.compile(mod.NAME)
            patches.put(owner, mod.ATTR, lambda orig, m=mod: m.wrap(orig, recorder))
    return patches


def run_units(traffic, state, seconds, on_unit=None):
    """Units until ``seconds`` have passed; returns (units, window s)."""
    import torch
    units = []
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    t0 = time.perf_counter()
    i = 0
    while True:
        u = {'index': i, 'mpx': 0.0, 'ok': False}
        t = time.perf_counter()
        try:
            if on_unit is not None:
                with on_unit():
                    out = traffic.unit(state, i)
            else:
                out = traffic.unit(state, i)
            if out is not None:
                u.update(out)
                u['ok'] = True
        except Exception:
            log(f'unit {i} raised:\n{traceback.format_exc()}')
        u['s'] = time.perf_counter() - t
        units.append(u)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    return units, time.perf_counter() - t0


def run(args, require_cuda=True, t_start=None, workload=None, config=None,
        patch=None, control=False, inspect=None):
    """One run; returns the result dict the last line prints. ``patch``,
    when given, is called with the traffic state after set-up (the fault
    tests break the timed path there). With ``control`` (``control.py``,
    never a benchmark run) the result also holds, as ``control_checks``,
    the numbers the control gives: the reference in bfloat16 put in the
    program's place on the same units. ``inspect``, when given, is called
    with the traffic module, its state and the units after the comparison,
    before the work dir goes."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_json(ROOT, 'BENCHMARK.json')
    entry = next((w for w in bench['workloads']
                  if w['name'] == args.workload), None)
    if entry is None:
        raise SystemExit(f'no workload {args.workload!r} in BENCHMARK.json')
    import torch
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < entry['chips']):
        raise SystemExit(f'{args.workload} needs {entry["chips"]} CUDA '
                         f'card(s); this host has '
                         f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
    # the program's build and kernel caches: fixed dirs in the checkout
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('CUDA_CACHE_PATH', 'cuda_cache')):
        os.environ[var] = os.path.join(RUN_DIR, 'cache', sub)
    from feabas_tpu_torch import device as device_mod
    dev = device_mod.get_device()
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    cell = Cell(args.workload, args.seed, dev, entry, workload, config)
    shutil.rmtree(cell.work, ignore_errors=True)
    os.makedirs(cell.work)
    traffic = load_module('traffic', entry['traffic'])
    state = traffic.setup(cell)
    if patch is not None:
        patch(state)
    cuda = dev.type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f'[bench] {args.workload} seed {args.seed}: set-up {setup_s:.3f} s')

    trace = None
    if args.trace:
        from roofline.common import peaks
        import profiling
        recorder = Recorder(peaks(torch.cuda.get_device_name(dev))
                            if cuda else None)
        patches = install_tracing(traffic, state, recorder, cuda)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)

        def on_unit():
            return torch.profiler.record_function(profiling.UNIT)
        try:
            with prof:
                with torch.profiler.record_function(profiling.WINDOW):
                    units, window_s = run_units(traffic, state, args.seconds,
                                                on_unit)
        finally:
            patches.restore()
    else:
        units, window_s = run_units(traffic, state, args.seconds)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f'[bench] window {window_s:.3f} s, {len(units)} units, '
        f'{sum(not u["ok"] for u in units)} failed; unit s '
        f'{json.dumps([round(u["s"], 3) for u in units])}')

    if args.trace:
        trace = profiling.digest(prof.profiler.kineto_results.events(),
                                 recorder.resolved(), recorder.names)
        trace.mpx = sum(u['mpx'] for u in units if u['ok'])
        trace.units = len(units)
        del prof
        log(f'[bench] traced: busy {trace.busy_s:.4f} s of '
            f'{trace.window_s:.4f} s, {trace.device_ops} device ops, '
            f'{trace.unattributed} with no host event, spans '
            f'{json.dumps(trace.span_s)}, kernel calls (bound s, calls, '
            f'device s) {json.dumps(trace.kernel_calls)}, attributed '
            f'{json.dumps(trace.attributed)}')

    # the program's state goes before the reference runs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = traffic.check(state, units)
    control_checks = traffic.check(state, units, control=True) \
        if control else None
    failed = sum(not u['ok'] for u in units)
    correct = (failed == 0 and bool(units)
               and all(v <= lim for _, v, lim in checks))

    metrics = {}
    if args.trace:
        for m in bench['per_layer']:
            if args.workload not in m.get('workloads', [args.workload]):
                continue
            value = load_module('metrics', m['name']).read(trace)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        done = sum(u['mpx'] for u in units if u['ok'])
        values = {'mpx_s': done / window_s, 'setup_s': setup_s}
        values.update(traffic.end_to_end(state, units))
        for m in bench['end_to_end']:
            if args.workload in m.get('workloads', [args.workload]):
                metrics[m['name']] = {'value': values[m['name']],
                                      'unit': m['unit']}
    result = {'correct': correct, 'attempted': len(units), 'failed': failed,
              'metrics': metrics,
              'device': {'platform': 'gpu' if cuda else dev.type,
                         'kind': torch.cuda.get_device_name(dev) if cuda else 'cpu',
                         'count': 1, 'memory_peak_bytes': int(peak)}}
    if trace is not None:
        result['device']['busy_s'] = trace.busy_s
        result['device']['window_s'] = trace.window_s
        result['breakdown'] = trace.breakdown
    if control_checks is not None:
        result['control_checks'] = {n: {'value': v, 'limit': lim}
                                    for n, v, lim in control_checks}
    result['checks'] = {n: {'value': v, 'limit': lim} for n, v, lim in checks}
    if inspect is not None:
        inspect(traffic, state, units)
    shutil.rmtree(cell.work, ignore_errors=True)
    for n, v, lim in checks:
        log(f'check {n} {v!r} limit {lim!r} {"ok" if v <= lim else "FAILED"}')
    return result


def main(argv=None, t_start=None):
    args = parse_args(argv)
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    result = run(args, t_start=t_start)
    leaked = sorted(m for m in sys.modules
                    if m.split('.')[0] in FORBIDDEN)
    if leaked:
        raise SystemExit(f'the run imported {leaked}')
    print(json.dumps(result))
    return 0
