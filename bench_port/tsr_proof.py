"""The readings the volume cell's correctness limits are set from.

    python3 bench_port/tsr_proof.py --seeds 11,12,13 --seconds <s>
        [--fault '<name>'] [--tiny]

For each seed, in one process: a run of ``align.tsr`` as the benchmark
makes it (set-up, the window, the comparison), then the same comparison
with the control in the program's place on the same units: the plain
reference computed in bfloat16, the nearest precision below the float32 it
computes in. With ``--fault``, one of ``FAULTS`` (or of ``SOUND``, the
render cell's: every transform moved one step of the 1/32 px snap) is
planted under the timed path after set-up. Prints one JSON line a seed:
the program's numbers and the control's, and the window's units. Each
limit lies above the largest sound reading and the readings of ``SOUND``,
and below the smallest reading of the faults it is there to catch and of
the control (PERF.md).

``--tiny`` runs at the small sizes of ``shrink``, on the CPU (the tests:
``tests/test_torch_tsr_cell.py``).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import harness  # noqa: E402
from render_proof import SOUND  # noqa: E402

CELL = 'align.tsr'

# The small sizes' limits, the cell's own: readings at these sizes (CPU,
# 3 seeds, 0.5 s windows; layer / square, LSB): sound runs 0.147-0.150 /
# 0.253-0.282 on the host route (the CPU's default), 0.0001-0.0002 /
# 0.0003-0.0007 on the card route (the plain raster); ``SOUND``: one snap
# step along x 0.471-0.505 / 0.527-0.587, on both axes 0.694-0.723 /
# 0.820-0.848; the control 22.9-23.1 / 25.2-26.2 (host), 8.69-8.89 /
# 9.15-10.19 (card); on the card route LINEAR in LANCZOS's place
# 2.22-2.24 / 2.48-2.49, two layers swapped 22.3-24.3 / 31.2-32.4, a chunk
# transposed 43.1-45.7 / 46.6-50.5, a layer shifted 1 px 14.2-14.8 /
# 15.2-16.5, a chunk missing 255 / 255.
TINY_LIMITS = {'render_err_lsb': 1.0, 'render_err_local_lsb': 1.3}


def shrink(workload, config):
    """The cell at a size a CPU test holds: 3 sections of 512^2 as 2 x 2
    tiles of 256^2, meshes of mesh_size 100, 256^2 quadrants in chunks of
    128 x 128 x 64 (4 xy chunks a unit, as the cell's), squares of 64 px;
    the drift and the warp's period scaled with the side, the warp's
    amplitude and the texture as the cell's."""
    d = config['deployment']
    d.update(section=512, tile=256, margin=48, drift_std=1.5,
             warp_period=128.0)
    workload['params']['pool'] = 3
    workload['reference']['local_px'] = 64
    over = config['overrides']['alignment_configs.yaml']
    over['meshing']['mesh_size'] = 100
    config['files']['default_alignment_configs.yaml']['meshing'][
        'mesh_size'] = 100
    over['tensorstore_rendering'].update(chunk_shape=[128, 128, 64],
                                         canvas_bbox=[0, 0, 256, 256])
    workload['limits'] = dict(TINY_LIMITS)
    return workload, config


def _wrap_slab(mp, edit):
    """``TensorStoreWriter.write_slab`` with its stack passed through
    ``edit(writer, bbox, z0, stack)``, which returns the stack to write or
    None to write nothing."""
    from feabas_tpu_torch import dal
    orig = dal.TensorStoreWriter.write_slab

    def write_slab(self, bbox, z0, stack, *a, **k):
        stack = edit(self, bbox, z0, stack)
        if stack is not None:
            return orig(self, bbox, z0, stack, *a, **k)
    mp.setattr(dal.TensorStoreWriter, 'write_slab', write_slab)


def _first(writer, bbox):
    """Whether ``bbox`` is the volume's first xy chunk."""
    return (bbox[0], bbox[1]) == tuple(writer.offset)


def _linear(st, mp):
    """The volume stage's LANCZOS read as LINEAR."""
    import cv2
    from feabas_tpu_torch import common, renderer
    orig = common.interp_from_name

    def linear(name, default=cv2.INTER_LINEAR):
        if str(name).upper() == 'LANCZOS':
            return cv2.INTER_LINEAR
        return orig(name, default)
    mp.setattr(common, 'interp_from_name', linear)
    mp.setattr(renderer, 'interp_from_name', linear)


def _swapped(st, mp):
    """Layers 0 and 1 of every chunk written in each other's place."""
    def edit(writer, bbox, z0, stack):
        if z0 == 0 and len(stack) > 1:
            stack = stack.copy()
            stack[[0, 1]] = stack[[1, 0]]
        return stack
    _wrap_slab(mp, edit)


def _transposed(st, mp):
    """The volume's first chunk written transposed in x and y."""
    def edit(writer, bbox, z0, stack):
        return stack.transpose(0, 2, 1) if _first(writer, bbox) else stack
    _wrap_slab(mp, edit)


def _shifted(st, mp):
    """Layer 1 of every chunk moved 1 px along x."""
    def edit(writer, bbox, z0, stack):
        if z0 <= 1 < z0 + len(stack):
            stack = stack.copy()
            stack[1 - z0, :, 1:] = stack[1 - z0, :, :-1]
        return stack
    _wrap_slab(mp, edit)


def _missing(st, mp):
    """The volume's first chunk never written."""
    _wrap_slab(mp, lambda writer, bbox, z0, stack:
               None if _first(writer, bbox) else stack)


FAULTS = {'LINEAR sampling in LANCZOS\'s place': _linear,
          'two sections\' layers swapped in z': _swapped,
          'one chunk written transposed in xy': _transposed,
          'one layer shifted 1 px': _shifted,
          'one chunk missing': _missing}


def sizes(tiny):
    """(workload, configuration) of the cell, shrunk where ``tiny``."""
    bench = harness.load_json(harness.ROOT, 'BENCHMARK.json')
    entry = next(w for w in bench['workloads'] if w['name'] == CELL)
    wl = harness.load_json(HERE, 'workloads', CELL + '.json')
    conf = harness.load_json(HERE, 'configs', entry['config'] + '.json')
    if tiny:
        shrink(wl, conf)
    return wl, conf


def run(seed, seconds, tiny=False, fault=None, control=True, trace=0,
        config=None):
    """One run of the cell; returns the harness's result with the units'
    quadrants and seconds under ``units``. ``config``, when given, is
    called with the configuration before the run (the tests set the
    render route there)."""
    import pytest
    import torch
    if torch.cuda.is_available():
        # the run's own peak, not the process's
        torch.cuda.reset_peak_memory_stats()
    wl, conf = sizes(tiny)
    if config is not None:
        config(conf)
    mp = pytest.MonkeyPatch()
    kw = {'workload': wl, 'config': conf, 'control': control}
    if tiny:
        kw['require_cuda'] = False
    if fault is not None:
        kw['patch'] = lambda state: {**FAULTS, **SOUND}[fault](state, mp)
    seen = []
    kw['inspect'] = lambda traffic, st, units: seen.extend(
        [list(u['quad']), round(u['s'], 3)] for u in units if u['ok'])
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
    p.add_argument('--fault', default=None,
                   choices=sorted(FAULTS) + sorted(SOUND))
    p.add_argument('--tiny', action='store_true')
    p.add_argument('--no-control', action='store_true')
    a = p.parse_args(argv)
    if a.tiny:
        os.environ.setdefault('FEABAS_TORCH_DEVICE', 'cpu')
    for seed in (int(s) for s in a.seeds.split(',')):
        r = run(seed, a.seconds, a.tiny, a.fault, not a.no_control)
        print(json.dumps({
            'seed': seed, 'fault': a.fault, 'correct': r['correct'],
            'attempted': r['attempted'], 'failed': r['failed'],
            'memory_peak_bytes': r['device']['memory_peak_bytes'],
            'program': {k: v['value'] for k, v in r['checks'].items()},
            'control': {k: v['value'] for k, v in
                        (r.get('control_checks') or {}).items()},
            'units': r['units']}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
