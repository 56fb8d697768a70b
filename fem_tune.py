"""Measurements of the general CG operator kernel (K5/K6g,
csrc/fem_operator.cu) on one CUDA card, on chip_smoke.py's phase-3 system
(``chip_smoke.fem_pair_system``: a pair of 1000 x 500-vertex meshes, 2M
DOF, 1e5 links).

    python3 fem_tune.py sweep   # threads a block x lanes a vertex, and the
                                # same pair without its links
    python3 fem_tune.py repeat  # which device sums and solves give the
                                # same bits call after call

``sweep`` builds copies of csrc/fem_operator.cu with 64, 128 and 256
threads a block under a temporary directory (``build.NVCC_FLAGS`` and
``-Xptxas -v``, whose register and spill lines it prints), loads each in
place of the package's library, and times every G on the pair (device µs,
``chip_smoke.graph_time``); then the pair with L = 0 at the package's
build, which shows what its links cost. ``repeat`` calls the operator, the
``index_add_`` sums (``ops/fem.scatter_uv``, ``_link_scatter``,
``crosslink_diag``, ``stiffness_matvec``, and one over 6 L link points of
the pair flattened as the match schedule's rounds flatten their anchors,
the form its per-round solve summed with: atomics on a CUDA tensor) and
the fixed-order sums of the same terms (``ops/fem.fixed_sum``, and the
solves' link sums ``link_transpose`` and ``link_diag``) 10 times each on
the pair, then each solve whose sums took a fixed order on
``chip_smoke.solve_cases``' seeded inputs (the fused ENG solve, the match
schedule's per-round solve, the stacked window solve in both its forms,
``relax_mesh``), and counts the calls whose bits differ from the first.
Each line names the card.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

THREADS = (64, 128, 256)


def _setup():
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from feabas_tpu_torch import device as device_mod
    if not torch.cuda.is_available():
        raise SystemExit('fem_tune: no CUDA device')
    os.environ[device_mod.DEVICE_ENV] = 'cuda'
    return chip_smoke, torch.device('cuda')


def _variant(threads, tmp):
    """csrc/fem_operator.cu built with ``threads`` threads a block: (the
    library's path, nvcc's -Xptxas -v output)."""
    from feabas_tpu_torch import build
    with open(os.path.join(build.SRC_DIR, 'fem_operator.cu')) as f:
        text, n = re.subn(r'constexpr int kThreads = \d+;',
                          f'constexpr int kThreads = {threads};', f.read())
    if n != 1:
        raise RuntimeError('kThreads not found in csrc/fem_operator.cu')
    path = os.path.join(tmp, f'fem_operator_{threads}.cu')
    with open(path, 'w') as f:
        f.write(text)
    lib = os.path.join(tmp, f'libfem_operator_{threads}.so')
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, '-Xptxas', '-v',
                           '-o', lib, path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    return lib, proc.stdout + proc.stderr


def _timed_groups(cs, system, label, out):
    from feabas_tpu_torch.ops import fem
    x, Ke, tables, *rest = system
    for g in fem.OPERATOR_GROUPS:
        op = fem.bind_elastic_operator(Ke, dict(tables, group=g), *rest)
        out[f'{label}, G {g}'] = {'device_us': cs.graph_time(lambda: op(x))}


def sweep(cs, dev):
    import torch
    from feabas_tpu_torch.ops import fem
    lib = fem._operator_lib()
    out = {}
    system = cs.fem_pair_system(dev)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(THREADS)) as pool:
            built = dict(zip(THREADS, pool.map(
                lambda t: _variant(t, tmp), THREADS)))
        ptxas = [ln for ln in built[128][1].splitlines()
                 if 'registers' in ln or 'spill' in ln]
        print('[ptxas] ' + '\n[ptxas] '.join(ptxas), flush=True)
        for threads, (path, _) in built.items():
            variant = ctypes.CDLL(path)
            for name in ('fem_operator_f32', 'fem_operator_f64'):
                getattr(variant, name).argtypes = getattr(lib, name).argtypes
                getattr(variant, name).restype = ctypes.c_int
            fem._LIBS['fem_operator'] = variant
            _timed_groups(cs, system, f'2M DOF, {threads} threads', out)
        fem._LIBS['fem_operator'] = lib
    del system
    torch.cuda.empty_cache()
    _timed_groups(cs, cs.fem_pair_system(dev, nl=0), '2M DOF, L = 0', out)
    return out


def repeat(cs, dev, n=10):
    import torch
    from feabas_tpu_torch.ops import fem
    x, Ke, t, weight, free, lam_s, lam_c = cs.fem_pair_system(dev)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    pe = torch.randn((t['nt'], 6), generator=g, device=dev)
    r = torch.randn((t['nl'], 2), generator=g, device=dev)
    nv = t['nv']
    tris = t['tris'].long()
    idx = torch.cat([t['idx1'], t['idx0']]).long()
    bary = torch.cat([t['bary1'], t['bary0']])
    by_corner = fem.fixed_sum(tris, nv)
    push = fem.link_sum(t['idx0'].long(), t['idx1'].long(), nv)
    op = fem.bind_elastic_operator(Ke, t, weight, free, lam_s, lam_c)
    calls = {
        f'operator G{t["group"]}': lambda: op(x),
        'scatter_uv': lambda: fem.scatter_uv(pe, tris, nv),
        '_link_scatter': lambda: fem._link_scatter(
            torch.zeros((nv, 2), device=dev), t['idx0'].long(), t['bary0'],
            r, 1.0),
        'crosslink_diag': lambda: fem.crosslink_diag(
            nv, t['idx0'].long(), t['bary0'], t['idx1'].long(), t['bary1'],
            weight),
        'stiffness_matvec': lambda: fem.stiffness_matvec(x, Ke, tris),
        'index_add_, flat anchors': lambda: torch.zeros(
            (nv, 2), device=dev).index_add_(0, idx.reshape(-1), (
                bary[:, :, None] * torch.cat([r, r])[:, None, :])
            .reshape(-1, 2)),
        'fixed_sum, elements': lambda: by_corner(pe.reshape(-1, 2)),
        'link_transpose': lambda: fem.link_transpose(push, t['bary0'],
                                                     t['bary1'], r),
        'link_diag': lambda: fem.link_diag(push, t['bary0'], t['bary1'],
                                           weight)}
    calls.update({f'solve {k}': fn for k, fn in cs.solve_cases(dev).items()})
    out = {}
    for name, fn in calls.items():
        first = fn()
        runs = [fn() for _ in range(n - 1)]
        out[name] = {'calls': n, 'differ_from_first': sum(
            not cs._same_bits(first, y) for y in runs)}
    return out


def main(argv):
    cs, dev = _setup()
    mode = argv[0] if argv else 'repeat'
    card = cs.card_line()
    res = {'sweep': sweep, 'repeat': repeat}[mode](cs, dev)
    for k, v in res.items():
        print(f'[{mode}] {k}: {json.dumps(v)} ({card})', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
