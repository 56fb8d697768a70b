"""The readings the render cell's correctness limits are set from.

    python3 bench_port/render_proof.py --seeds 11,12,13 --seconds <s>
        [--fault '<name>'] [--tiny]

For each seed, in one process: a run of ``align.render`` as the benchmark
makes it (set-up, the window, the comparison), then the same comparison
with the control in the program's place on the same units: the plain
reference computed in bfloat16, the nearest precision below the float32 it
computes in. With ``--fault``, one of ``FAULTS`` (or of ``SOUND``) is
planted under the timed path after set-up. Prints one JSON line a seed: the
program's numbers and the control's, and the window's units. Each limit
lies above the largest sound reading and the readings of ``SOUND``, and
below the smallest reading of the faults it is there to catch and of the
control (PERF.md).

``--tiny`` runs at the small sizes of ``shrink``, on the CPU (the tests:
``tests/test_torch_render_cell.py``).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import harness  # noqa: E402

CELL = 'align.render'
# The square the local fault shifts: the middle one of a tile, in units of
# the cell's ``local_px``.
LOCAL = 128

# The small sizes' limits, the cell's own: readings at these sizes (CPU,
# 3 seeds, 0.5 s windows; tile / square, LSB): sound runs 0.060-0.061 /
# 0.116-0.120 on the host route (the CPU's default), 0 / 0 on the card
# route (the plain raster); ``SOUND``: one snap step along x 0.429-0.437 /
# 0.453-0.462, on both axes 0.646-0.655 / 0.675-0.694; the control
# 17.2-17.4 / 20.2-21.1; on the card route LINEAR in LANCZOS's place
# 2.07-2.09 / 2.20-2.22, the tforms moved 1 px 13.6-13.7 / 14.2-14.7, one
# square shifted 1 px 3.41-3.50 / 13.5-14.0 (a quarter of a 256^2 tile).
TINY_LIMITS = {'render_err_lsb': 1.0, 'render_err_local_lsb': 1.3}


def shrink(workload, config):
    """The cell at a size a CPU test holds: 3 sections of 512^2 as 2 x 2
    tiles of 256^2, rendered to 256^2 tiles, meshes of mesh_size 100
    (about 70 triangles); the drift and the warp's period scaled with the
    side, the warp's amplitude and the texture as the cell's."""
    d = config['deployment']
    d.update(section=512, tile=256, margin=48, drift_std=1.5,
             warp_period=128.0)
    workload['params']['pool'] = 3
    over = config['overrides']['alignment_configs.yaml']
    over['meshing']['mesh_size'] = 100
    config['files']['default_alignment_configs.yaml']['meshing'][
        'mesh_size'] = 100
    over['rendering'].update(tile_size=[256, 256], canvas_bbox=[0, 0, 512, 512])
    workload['limits'] = dict(TINY_LIMITS)
    return workload, config


def _move_tforms(st, by):
    """Every section's transform moved by ``by`` (x, y) px."""
    from feabas_tpu_torch.mesh import Mesh
    tform_dir = os.path.join(st.pool_wd, 'align', 'tform')
    for name in st.names:
        t = os.path.join(tform_dir, name + '.h5')
        m = Mesh.from_h5(t)
        m.set_offset(m.offset('MOVING') + [list(by)], 'MOVING')
        m.save_to_h5(t)


def _moved_tforms(st, mp):
    """Every section's transform moved 1 px along x."""
    _move_tforms(st, (1.0, 0.0))


def _snap_step_x(st, mp):
    """Every section's transform moved 1/32 px along x: every px sampled
    one step of the 1/32 px snap apart along x, as where the f32 rounding
    of a coordinate within ~1e-4 px of a snap midpoint puts the program's
    snap and the reference's on either side of it, here on every px of
    every section (a pure translation, such as section 0's, puts every px
    of a section at one fraction)."""
    _move_tforms(st, (1.0 / 32, 0.0))


def _snap_step_xy(st, mp):
    """As ``_snap_step_x`` on both axes at once: the most such a rounding
    can move a px."""
    _move_tforms(st, (1.0 / 32, 1.0 / 32))


def _linear(st, mp):
    """The rendering stage's LANCZOS read as LINEAR."""
    import cv2
    from feabas_tpu_torch import common
    orig = common.interp_from_name

    def linear(name, default=cv2.INTER_LINEAR):
        if str(name).upper() == 'LANCZOS':
            return cv2.INTER_LINEAR
        return orig(name, default)
    mp.setattr(common, 'interp_from_name', linear)


def _square(st, mp):
    """In each output tile written, the middle ``LOCAL`` square's content
    moved 1 px along x."""
    from feabas_tpu_torch import common
    orig = common.imwrite

    def shifted(path, img, *a, **k):
        h, w = img.shape[:2]
        y = x = min(h, w) // LOCAL // 2 * LOCAL
        img = img.copy()
        img[y:y + LOCAL, x:x + LOCAL] = img[y:y + LOCAL, x - 1:x + LOCAL - 1]
        return orig(path, img, *a, **k)
    mp.setattr(common, 'imwrite', shifted)


FAULTS = {'tforms moved 1 px': _moved_tforms,
          'LINEAR sampling in LANCZOS\'s place': _linear,
          'one 128^2 square of each tile shifted 1 px': _square}
# What a sound run may differ by, planted as the faults are: each reads
# under every limit.
SOUND = {'one snap step along x': _snap_step_x,
         'one snap step on both axes': _snap_step_xy}


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
        inspect=None):
    """One run of the cell; returns the harness's result with the units'
    sections and seconds under ``units``."""
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
        kw['patch'] = lambda state: {**FAULTS, **SOUND}[fault](state, mp)
    seen = []

    def look(traffic, st, units):
        seen.extend([u['z'], round(u['s'], 3)] for u in units if u['ok'])
        if inspect is not None:
            inspect(traffic, st, units)
    kw['inspect'] = look
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
            'metrics': {k: v['value'] for k, v in r['metrics'].items()},
            'memory_peak_bytes': r['device']['memory_peak_bytes'],
            'program': {k: v['value'] for k, v in r['checks'].items()},
            'control': {k: v['value'] for k, v in
                        (r.get('control_checks') or {}).items()},
            'units': r['units']}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
