"""CPU rehearsal of the benchmark, without a card.

    python3 bench_port/rehearse.py

Loads every file ``BENCHMARK.json`` names, by name, as the harness finds
it (each workload, configuration, traffic, per-layer metric and roofline
module), checks each against the entries that name it, checks the copied
bound arithmetic against counts made by hand on small shapes, and scans
every Python file under the benchmark's folder for an import of ``jax``,
the JAX package (``feabas_tpu``), ``chip_smoke`` or the root ``bench``.
Exits non-zero at the first failure. The correctness tests (a sound run,
the control and the planted faults, at small sizes on the CPU) are
``test_correct.py``.
"""

import ast
import json
import math
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness  # noqa: E402

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
FORBIDDEN = ('jax', 'feabas_tpu', 'chip_smoke', 'bench')


def fail(msg):
    raise SystemExit(f'rehearse: {msg}')


def check_benchmark():
    b = harness.load_json(harness.ROOT, 'BENCHMARK.json')
    want = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
            'end_to_end', 'per_layer'}
    if set(b) != want:
        fail(f'BENCHMARK.json keys {sorted(b)}')
    names = set()
    for c in b['configs']:
        if not NAME.match(c['name']) or c['name'] in names:
            fail(f'config name {c["name"]!r}')
        names.add(c['name'])
        conf = harness.load_json(harness.ROOT, c['file'])
        if conf['name'] != c['name']:
            fail(f'{c["file"]} names {conf["name"]!r}')
        for k in c['reduced']:
            if not NAME.match(k) or k not in conf['reduced']:
                fail(f'{c["name"]}: reduced key {k!r} not in its file')
        for k in conf['reduced']:
            if k not in c['reduced']:
                fail(f'{c["name"]}: {k!r} cut in its file, not listed')
        for k in c['reduced']:
            if re.search(r'(_dim|_rank|_size|width)$', k):
                fail(f'{c["name"]}: {k!r}, a width, in reduced')
    cells = {}
    for w in b['workloads']:
        if not NAME.match(w['name']) or w['name'] in cells:
            fail(f'workload name {w["name"]!r}')
        if w['config'] not in names or w['chips'] not in (1, 4):
            fail(f'workload {w["name"]}')
        if len(w['why']) > 200:
            fail(f'{w["name"]}: why longer than 200 characters')
        wl = harness.load_json(HERE, 'workloads', w['name'] + '.json')
        if (wl['config'], wl['traffic']) != (w['config'], w['traffic']):
            fail(f'{w["name"]}: its file names {wl["config"]}/{wl["traffic"]}')
        traffic = harness.load_module('traffic', w['traffic'])
        for fn in ('setup', 'unit', 'spans', 'end_to_end', 'check'):
            if not callable(getattr(traffic, fn, None)):
                fail(f'traffic {w["traffic"]} has no {fn}()')
        cells[w['name']] = wl
    metrics = set()
    for m in b['end_to_end'] + b['per_layer']:
        if not NAME.match(m['name']) or m['name'] in metrics:
            fail(f'metric name {m["name"]!r}')
        metrics.add(m['name'])
        if not UNIT.match(m['unit']) or m['better'] not in ('lower', 'higher'):
            fail(f'metric {m["name"]}: unit or better')
        for c in m.get('workloads', []):
            if c not in cells:
                fail(f'metric {m["name"]} lists an unknown cell {c}')
    for m in b['end_to_end']:
        if not 0 < m['bound'] <= 0.25 or m['source'] not in (
                'host_clock', 'device_trace'):
            fail(f'end-to-end {m["name"]}: bound or source')
    e2e = {m['name'] for m in b['end_to_end']}
    for m in b['per_layer']:
        if m['moves'] not in e2e:
            fail(f'{m["name"]} moves {m["moves"]}, no end-to-end metric')
        mod = harness.load_module('metrics', m['name'])
        if not callable(getattr(mod, 'read', None)):
            fail(f'metrics/{m["name"]}.py has no read()')
        if m['name'].endswith('_roofline'):
            kernel = m['name'][:-len('_roofline')]
            rl = harness.load_module('roofline', kernel)
            re.compile(rl.NAME)
            if rl.KERNEL != kernel:
                fail(f'roofline/{kernel}.py counts {rl.KERNEL}')
    if 'setup_s' not in e2e:
        fail('no setup_s')
    print(f'rehearse: BENCHMARK.json, {len(b["configs"])} configurations, '
          f'{len(cells)} cells, {len(metrics)} metrics: every file found')


def check_bounds():
    """The copied bound arithmetic against counts made by hand."""
    import torch
    from roofline import fem_operator, montage_blend
    pk = {'float32_flops': 67e12, 'float64_flops': 34e12, 'bytes': 3.35e12}

    def near(got, want, what):
        if not math.isclose(got, want, rel_tol=1e-12):
            fail(f'{what}: {got} s, by hand {want} s')

    # 4 vertices, 2 elements, one link listed on both sides (6 entries)
    i32 = torch.int32
    tables = {'nv': 4, 'nt': 2, 'bary0': torch.zeros(1),
              'lnk_ent': torch.arange(6, dtype=i32),
              'lnk_ptr': torch.tensor([0, 6], dtype=i32)}
    floats = 2 * 36 + 3 * 2 + 1 + 4 + 2 * 4 + 2 * 4       # Ke, bary, w, free, x, y
    ints = 2 * 3 + 3 * 2                                   # tris, side indices
    flop = 2 * 3 * 26 + 2 * 12 + 1 * 6 + 3 * 2 * 4 + 4 * 8
    near(fem_operator.call_bound(pk, tables),
         max(flop / 67e12, (4 * floats + 4 * ints) / 3.35e12), 'fem_operator')
    tables['lnk_ptr'] = torch.tensor([0, 0], dtype=i32)    # no link listed
    floats, ints = 2 * 36 + 4 + 8 + 8, 2 * 3
    near(fem_operator.call_bound(pk, tables),
         max((2 * 3 * 26 + 32) / 67e12, (4 * floats + 4 * ints) / 3.35e12),
         'fem_operator without links')

    # one 64 x 64 cell, one tile: a triangle over the whole cell and a
    # padding row (weight -inf); every pixel covered once, one row kept
    tab = torch.zeros((1, 2, 14))
    tab[0, 0, :6] = torch.tensor([1 / 201, 0, 1 / 201, 0, 1 / 201, 1 / 201])
    tab[0, 0, 12] = 1.0
    tab[0, 1, 12] = -math.inf
    cands = torch.zeros((1, 1), dtype=torch.int64)
    gmap = torch.zeros(1, dtype=torch.int64)
    aux = torch.zeros((1, 5))
    px = 64 * 64
    nbytes = px + px + 4 * (28 + 5) + 8 * (1 + 1)
    flop = 1 * px * 13 + px * 7 + px * 52
    near(montage_blend.call_bound(pk, gmap, tab, aux, cands, 1, 1, 'u8', False),
         max(flop / 67e12, nbytes / 3.35e12), 'montage_blend')
    print('rehearse: fem_operator and montage_blend bounds '
          'equal the hand counts')


def check_imports():
    n = 0
    for root, _, files in os.walk(HERE):
        if '_run' in root.split(os.sep):
            continue
        for fn in files:
            if not fn.endswith('.py'):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or '']
                for m in mods:
                    if m.split('.')[0] in FORBIDDEN:
                        fail(f'{path} imports {m}')
            n += 1
    print(f'rehearse: {n} Python files, none imports {", ".join(FORBIDDEN)}')


def main():
    check_benchmark()
    check_bounds()
    check_imports()
    print(json.dumps({'rehearsal': 'ok'}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
