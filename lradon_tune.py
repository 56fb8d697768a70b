"""Measurements of the LRadon descriptor (K16) and match (K17) kernels on one
CUDA card, at the thumbnail path's shapes (chip_smoke.py's phase-3 cases).

    python3 lradon_tune.py profile   # device time by kernel (torch.profiler)
    python3 lradon_tune.py ab        # call ms and CUDA-graph device us
    python3 lradon_tune.py sweep     # K17 design sweep, K16 ablations
    python3 lradon_tune.py recheck N # K1, K16, K17 against plain, N times

``recheck`` runs the DoG/blur kernel (K1) on chip_smoke.py's phase-3
shapes and the small K16 / K17 cases against their plain versions and
counts disagreements; it is small enough to run under
``compute-sanitizer --tool memcheck|racecheck|initcheck`` with N = 1.

``ab`` runs in any checkout that has chip_smoke.py's ``lradon_cases`` (copy
the script into an unpacked older commit to time its kernels in the same
call). ``sweep`` builds edited copies of csrc/lradon_match.cu and
csrc/lradon_patch.cu under a temporary directory (nvcc, sm_90a) and loads
each in place of the package's library: K17 with 1 or 2 variants per
pass-1 block and the product loop unrolled fully, by 8 or by 16, and its
pass 2 at one or two blocks per SM and 3, 6 or 10 column chunks (5000 x
5000 x 12); K16 with its products, or its patch blend, compiled out (K
5000 on 2048^2). Each line names the card.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']
PATH_ROWS = (('lradon_patch', 'K 5000'), ('lradon_patch', 'K 4096, 3000x2000'),
             ('lradon_match', '5000 x 5000'), ('lradon_match', '64 x 4096'))


def _setup():
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from feabas_tpu_torch import device as device_mod
    if not torch.cuda.is_available():
        raise SystemExit('lradon_tune: no CUDA device')
    os.environ[device_mod.DEVICE_ENV] = 'cuda'
    return chip_smoke, torch.device('cuda')


def _args(cs, dev, kernel, name):
    return dict(cs.lradon_cases(dev, kernel))[name]()['args']


def graph_us(fn, n=20):
    """Device microseconds per call: n calls in one CUDA graph, replayed."""
    import torch
    from chip_smoke import cuda_time
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    return cuda_time(graph.replay, iters=10) / n * 1e3


def ab(cs, dev):
    from feabas_tpu_torch.ops import lradon
    out = {}
    for kernel, name in PATH_ROWS:
        args = _args(cs, dev, kernel, name)
        fn = getattr(lradon, kernel)
        out[f'{kernel} {name}'] = {'ms': cs.cuda_time(lambda: fn(*args), 20),
                                   'graph_us': graph_us(lambda: fn(*args))}
    return out


def profile(cs, dev):
    import torch
    from torch.profiler import ProfilerActivity, profile as prof
    from feabas_tpu_torch.ops import lradon
    out = {}
    for kernel, name in PATH_ROWS:
        args = _args(cs, dev, kernel, name)
        fn = getattr(lradon, kernel)
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            for _ in range(10):
                fn(*args)
            torch.cuda.synchronize()
        out[f'{kernel} {name}'] = {
            e.key[:48]: e.device_time_total / 10 for e in p.key_averages()
            if getattr(e, 'device_time_total', 0) > 0
            and 'kernel' in e.key}
    return out


def _build(item):
    from feabas_tpu_torch.build import _nvcc
    path, text = item
    with open(path + '.cu', 'w') as f:
        f.write(text)
    subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', path + '.so', path + '.cu'],
                   check=True, capture_output=True)
    return path


def _edit(text, old, new):
    if old not in text:
        raise RuntimeError(f'sweep: {old!r} not in the source')
    return text.replace(old, new)


def sweep(cs, dev):
    import torch
    from feabas_tpu_torch.ops import lradon
    csrc = os.path.join(REPO, 'feabas_tpu_torch', 'csrc')
    msrc = open(os.path.join(csrc, 'lradon_match.cu')).read()
    psrc = open(os.path.join(csrc, 'lradon_patch.cu')).read()
    loop = '#pragma unroll 16\n  for (int j = 0; j < n; ++j) {'
    kvar = 'constexpr int kVar = 2;'
    lb = '__launch_bounds__(kThreads, 2)\nreduce_kernel'
    prod = 'acc = fmaf(wts[s * PB + q], bl[offs[s * PB + q]], acc);'
    blend = 'for (int dy0 = 0; dy0 < Dp; dy0 += kStrip) {'
    tmp = tempfile.mkdtemp(prefix='lradon_tune_')
    match = {}
    for kv in (1, 2):
        for unroll in ('', ' 8', ' 16'):
            text = _edit(_edit(msrc, kvar, f'constexpr int kVar = {kv};'),
                         loop, loop.replace(' 16', unroll))
            match[f'pass1 kVar {kv}, unroll{unroll or " full"}'] = (
                text, kv, None)
    for blocks in (1, 2):
        text = _edit(msrc, lb, lb.replace('2)', f'{blocks})'))
        for chunks in (3, 6, 10):
            match[f'pass2 {blocks} block(s)/SM, {chunks} chunks'] = (
                text, 2, chunks)
    patch = {'as built': psrc,
             'products compiled out': _edit(psrc, prod, 'acc = bl[q];'),
             'blend compiled out': _edit(psrc, blend,
                                         blend.replace('dy0 < Dp', 'dy0 < 0'))}
    items = [(os.path.join(tmp, f'm{i}'), t[0]) for i, t in
             enumerate(match.values())]
    items += [(os.path.join(tmp, f'p{i}'), t) for i, t in
              enumerate(patch.values())]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(_build, items))
    margs = _args(cs, dev, 'lradon_match', '5000 x 5000')
    want = lradon.lradon_match(*margs)
    lib0 = lradon._match_lib()
    plan, kv0 = lradon._match_plan, lradon.MATCH_VARIANTS_PER_BLOCK
    out = {}
    try:
        for i, (name, (_, kv, chunks)) in enumerate(match.items()):
            lib = ctypes.CDLL(os.path.join(tmp, f'm{i}.so'))
            lib.lradon_match_f32.argtypes = lib0.lradon_match_f32.argtypes
            lib.lradon_match_f32.restype = ctypes.c_int
            lradon._LIBS['lradon_match'] = lib
            lradon.MATCH_VARIANTS_PER_BLOCK = kv
            if chunks is not None:
                lradon._match_plan = \
                    lambda *a, c=chunks: plan(*a)[:2] + (c,)
            got = lradon.lradon_match(*margs)
            out[name] = {
                'ms': cs.cuda_time(lambda: lradon.lradon_match(*margs), 20),
                'same_result': all(torch.equal(a, b)
                                   for a, b in zip(got, want))}
            if chunks is not None:
                one = margs[:4] + (margs[4], False)
                out[name]['no_search_ms'] = cs.cuda_time(
                    lambda: lradon.lradon_match(*one), 20)
            lradon._match_plan = plan
        lradon.MATCH_VARIANTS_PER_BLOCK = kv0
        lradon._LIBS['lradon_match'] = lib0
        pargs = _args(cs, dev, 'lradon_patch', 'K 5000')
        lib0 = lradon._patch_lib()
        for i, name in enumerate(patch):
            lib = ctypes.CDLL(os.path.join(tmp, f'p{i}.so'))
            lib.lradon_patch_f32.argtypes = lib0.lradon_patch_f32.argtypes
            lib.lradon_patch_f32.restype = ctypes.c_int
            lradon._LIBS['lradon_patch'] = lib
            out[f'K16 {name}'] = {'graph_us': graph_us(
                lambda: lradon.lradon_patch(*pargs))}
    finally:
        lradon._match_plan = plan
        lradon.MATCH_VARIANTS_PER_BLOCK = kv0
        lradon._LIBS.pop('lradon_match', None)
        lradon._LIBS.pop('lradon_patch', None)
    return out


# chip_smoke.py's phase-3 K1 shapes: (shape, sigma, DoG or blur)
K1_ROWS = [((384, 128, 128), 2.5, True), ((64, 128, 128), 2.5, True),
           ((2048, 96, 96), 2.5, True), ((1536, 64, 64), 2.5, True),
           ((256, 64, 64), 2.5, True), ((512, 192, 192), 2.5, True),
           ((1, 224, 2016), 1.25, True), ((1, 1504, 256), 1.25, True),
           ((1, 224, 256), 1.25, True),
           ((1, 224, 2016), 1.25 * 2 ** .5, False),
           ((1, 1504, 256), 1.25 * 2 ** .5, False),
           ((1, 4096, 4096), 4.0, False), ((512, 96, 96), 3.5, True),
           ((8192, 24, 24), 3.5, True), ((1, 2048, 2048), 3.5, True),
           ((128, 192, 192), 3.5, True), ((128, 64, 64), 3.5, True),
           ((1, 1, 1), 2.5, True), ((1, 4000, 3), 2.5, True),
           ((4, 24, 24), 3.5, True), ((2, 129, 130), 2.5, True),
           ((2, 129, 130), 3.5 * 2 ** .5, False)]
SMALL_CASES = (('lradon_patch', ('K 64, borders and corners',
                                 'radius 45, one per block',
                                 '4 x 6 bins, width 1, radius 9.5')),
               ('lradon_match', ('side 0 masked', 'dlen 24 (4 x 6)',
                                 '100 x 3001', 'duplicates')))


def recheck(cs, dev, n=1):
    import torch
    from feabas_tpu_torch.ops import dog
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    bad = 0
    for _ in range(n):
        for shape, sigma, is_dog in K1_ROWS:
            x = torch.rand(shape, generator=g, device=dev) * 255
            k = dog.dog_filter if is_dog else dog.gaussian_blur
            p = dog.dog_filter_plain if is_dog else dog.gaussian_blur_plain
            if not float((k(x, sigma) - p(x, sigma)).abs().max()) <= cs.ATOL:
                bad += 1
    out = {'K1 rows checked': n * len(K1_ROWS), 'K1 rows bad': bad}
    for kernel, names in SMALL_CASES:
        cases = dict(cs.lradon_cases(dev, kernel))
        for name in names:
            out[f'{kernel} {name}'] = cs.lradon_compare(kernel,
                                                        cases[name]())
    torch.cuda.synchronize()
    return out


def main(argv=None):
    argv = argv or sys.argv[1:] or ['ab']
    what = argv[0]
    cs, dev = _setup()
    if what == 'recheck':
        result = recheck(cs, dev, int(argv[1]) if len(argv) > 1 else 1)
    else:
        result = {'ab': ab, 'profile': profile, 'sweep': sweep}[what](cs, dev)
    card = cs.card_line()
    for k, v in result.items():
        print(f'[{what}] {os.path.basename(os.getcwd())} {k}: '
              f'{json.dumps(v)} ({card})', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
