"""Volume rendering of the aligned stack through the align CLI
(``align_main --mode tsr``), one quadrant of the canvas a unit.

Set-up: ``align_render``'s: the align cells' seeded pool of ``pool``
sections written as stitched sections, meshed by the CLI's meshing, each
section's transform its mesh at the true aligned positions
(``traffic/align_render.write_tforms``); one unit rendered untimed; every
file the set-up wrote made durable. A unit is one tsr call over every
section of the pool into a fresh volume directory
(``tensorstore_rendering.out_dir``) in a fresh work dir (the stitched
sections and transforms linked in), with ``canvas_bbox`` one quadrant of
the section's canvas, cycling (0, 0), (s/2, 0), (0, s/2), (s/2, s/2): the
configuration's chunk shape, interpolation, encoding and loader settings
as shipped. A unit's work is the quadrant's px of every section at mip 0.

A program whose mesh raster has no Lanczos-4 mode stops at the start of
the set-up, exiting non-zero, as ``align_render`` does.

Correct: every chunk the window's units wrote, read back by the plain
reader (``reference/volume.read_precomputed``), held layer by layer
against the plain reference render of that section over the chunk's box
(``reference/volume.expected_chunk``, on the card; its sources read from
the pool's tiles): over the px the reference covers, each layer's mean
|difference| (the worst layer's is ``render_err_lsb``), and each
``local_px`` square's with at least half its px covered (the worst
square's is ``render_err_local_lsb``). A layer the reference covers whose
chunk the window did not write, or a volume the reader cannot read or of
another size than the quadrant's, reads MISSING_LSB.
"""

import copy
import os
import types

import torch

import harness
from inputs import align_pool
from inputs.workdir import use_config
from reference.volume import expected_chunk, read_precomputed

align_render = harness.load_module('traffic', 'align_render')
MISSING_LSB = align_render.MISSING_LSB


class State:
    pass


def _tsr_conf(conf):
    """The configuration's tensorstore_rendering settings as run."""
    t = copy.deepcopy(conf['files']['default_alignment_configs.yaml'][
        'tensorstore_rendering'])
    t.update(conf['overrides']['alignment_configs.yaml'].get(
        'tensorstore_rendering', {}))
    return t


def quadrant(st, i):
    """Unit ``i``'s canvas quadrant: its (x0, y0)."""
    h = st.d['section'] // 2
    return ((0, 0), (h, 0), (0, h), (h, h))[i % 4]


def setup(cell):
    from feabas_tpu_torch.scripts import align_main
    align_render.require_lanczos_raster()
    st = State()
    st.cell = cell
    st.d = cell.config['deployment']
    st.p = cell.workload['params']
    st.pool_wd, cfg, st.names, st.drift, _ = align_pool.write_pool(
        cell, st.p['pool'])
    use_config(cfg)
    align_main.main(['--mode', 'meshing'])
    align_render.write_tforms(st)
    if unit(st, 0, tag='warm') is None:
        raise RuntimeError('the warm-up unit wrote no volume')
    align_render._fsync_tree(cell.work)
    return st


def unit(st, i, tag=None):
    from feabas_tpu_torch.scripts import align_main
    tag = i if tag is None else tag
    x0, y0 = quadrant(st, i)
    h = st.d['section'] // 2
    out = os.path.join(st.cell.work, f'pass_{tag}', 'volume')
    if os.path.exists(out):
        raise RuntimeError(f'{out} exists before its unit')
    conf = copy.deepcopy(st.cell.config)
    tsr = conf['overrides']['alignment_configs.yaml'].setdefault(
        'tensorstore_rendering', {})
    tsr.update(canvas_bbox=[x0, y0, x0 + h, y0 + h], out_dir=out)
    cfg, _ = align_pool.pass_dir(
        types.SimpleNamespace(work=st.cell.work, config=conf), st.pool_wd,
        tag, ['stitched_sections', os.path.join('align', 'tform')])
    use_config(cfg)
    align_main.main(['--mode', 'tsr'])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if not os.path.exists(os.path.join(out, 'info')):
        return None
    return {'mpx': h * h * len(st.names) / 1e6, 'quad': (x0, y0),
            'dir': out}


def spans(st):
    from feabas_tpu_torch import dal
    from feabas_tpu_torch.renderer import MeshRenderer
    return [(MeshRenderer, 'crop_multiple', 'render.raster'),
            (MeshRenderer, 'crop', 'render.raster'),
            (dal.StaticImageLoader, 'crop', 'loader'),
            (dal.TensorStoreWriter, 'write_slab', 'volume.write'),
            (dal.TensorStoreWriter, 'write_single_chunk', 'volume.write')]


def _read(u, shape):
    """The unit's volume as ``read_precomputed`` reads it, or None where
    it cannot, or where its size is not ``shape`` (c, z, y, x)."""
    try:
        vol = read_precomputed(u['dir'])
    except (OSError, ValueError, KeyError, IndexError):
        return None
    return vol if vol['data'].shape == shape else None


def _layer(vol, z, x0, y0, x1, y1):
    """Layer z of the volume over the volume-frame box, or None where its
    chunk was not written."""
    cx, cy, cz = vol['chunk']
    if not vol['present'][z // cz, y0 // cy, x0 // cx]:
        return None
    return vol['data'][0, z, y0:y1, x0:x1]


def check(st, units, control=False):
    """The worst layer's and the worst square's mean |difference| over the
    window's units; with ``control``, of the reference computed in
    bfloat16 in the program's place."""
    dev = torch.device('cuda') if torch.cuda.is_available() \
        else torch.device('cpu')
    local = st.cell.workload['reference']['local_px']
    t = _tsr_conf(st.cell.config)
    fill = float(t['loader_config']['fillval'])
    cx, cy = int(t['chunk_shape'][0]), int(t['chunk_shape'][1])
    h = st.d['section'] // 2
    nz = len(st.names)
    ok = [u for u in units if u['ok']]
    vols = {u['index']: _read(u, (1, nz, h, h)) for u in ok}
    srcs = [align_render._section(st, z, dev) for z in range(nz)] \
        if ok else []
    worst, worst_local = (0.0, 0.0) if ok else (MISSING_LSB, MISSING_LSB)
    for qx, qy in sorted({u['quad'] for u in ok}):
        mine = [u for u in ok if u['quad'] == (qx, qy)]
        for oy in range(0, h, cy):
            for ox in range(0, h, cx):
                box = (ox, oy, min(ox + cx, h), min(oy + cy, h))
                bbox = (qx + box[0], qy + box[1], qx + box[2], qy + box[3])
                ref, cov = expected_chunk(srcs, st.meshes, bbox, fill)
                ctrl = expected_chunk(srcs, st.meshes, bbox, fill,
                                      torch.bfloat16)[0] if control else None
                for z in range(nz):
                    if not bool(cov[z].any()):
                        continue
                    for u in mine:
                        vol = vols[u['index']]
                        g = ctrl[z] if control else \
                            None if vol is None else _layer(vol, z, *box)
                        if g is None:
                            worst = worst_local = MISSING_LSB
                            continue
                        m, loc = align_render._errors(
                            torch.as_tensor(g).to(dev), ref[z], cov[z],
                            local)
                        worst = max(worst, m)
                        if loc is not None:
                            worst_local = max(worst_local, loc)
    lim = st.cell.workload['limits']
    return [('render_err_lsb', worst, lim['render_err_lsb']),
            ('render_err_local_lsb', worst_local,
             lim['render_err_local_lsb'])]


def end_to_end(st, units):
    return {}
