"""Rendering of aligned sections through the align CLI
(``align_main --mode rendering --start z --stop z+1``), one section a unit.

Set-up: the align cells' seeded pool of ``pool`` sections written as
stitched sections (``inputs/align_pool.py``) and meshed by the CLI's
meshing; each section's transform written where the optimization stage
writes it (``align/tform/<name>.h5``): its mesh with every vertex p moved
to where the section's content truly lies in the aligned frame,
p + d_z(p), d_z the seeded drift and warp of ``inputs/align_stack.py``
(section 0, with no warp of its own, a pure translation); one section
rendered untimed; every file the set-up wrote made
durable (``fsync``), so that none of its ~0.6 GB is still being written
back while the window runs. The window cycles the pool; each
pass over it works in a fresh work dir (the stitched sections and the
transforms linked in, no rendered section), so the CLI never finds a
section's metadata.txt it would skip. A unit's work is one section at
mip 0.

A program whose mesh raster has no Lanczos-4 mode stops at the start of
the set-up, exiting non-zero: it would render every section on the host.

Correct: every output tile of the window, read back, against the plain
reference render of the same mesh from the same section
(``reference/render.py``, on the card in blocks, its source read from the
pool's tiles): over the pixels the reference covers, each tile's mean
|difference| (the worst tile's is ``render_err_lsb``), and each
``local_px`` square's with at least half its pixels covered (the worst
square's is ``render_err_local_lsb``). A tile the reference covers and the
window did not write reads MISSING_LSB.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import torch

from inputs import align_pool
from inputs.align_stack import disp
from inputs.workdir import use_config
from reference.render import render

MISSING_LSB = 255.0


class State:
    pass


def _pass_dir(st, tag):
    if tag not in st.passes:
        st.passes[tag] = align_pool.pass_dir(
            st.cell, st.pool_wd, tag,
            ['stitched_sections', os.path.join('align', 'tform')])
    return st.passes[tag]


def write_tforms(st):
    """Each section's mesh, its MOVING gear at the true aligned positions,
    saved where the optimization stage commits it; keeps the arrays the
    reference renders from."""
    from feabas_tpu_torch.mesh import Mesh
    st.meshes = []
    tform_dir = os.path.join(st.pool_wd, 'align', 'tform')
    os.makedirs(tform_dir, exist_ok=True)
    for z, name in enumerate(st.names):
        m = Mesh.from_h5(os.path.join(st.pool_wd, 'align', 'mesh',
                                      name + '.h5'))
        v = m.vertices_w_offset('INITIAL')
        dx, dy = disp(st.d, z, st.drift, v[:, 0], v[:, 1], np)
        moved = v + np.stack([dx, dy], -1)
        c = moved.mean(axis=0, keepdims=True)
        m.set_vertices(moved - c, 'MOVING', offset=c)
        m.save_to_h5(os.path.join(tform_dir, name + '.h5'))
        st.meshes.append((moved, v, np.asarray(m.triangles)))


def _fsync_tree(root):
    """``os.fsync`` every regular file under ``root`` (links not
    followed)."""
    for d, _, files in os.walk(root):
        for fn in files:
            path = os.path.join(d, fn)
            if os.path.islink(path):
                continue
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


def require_lanczos_raster():
    """Stop, before any input is made, where the program's mesh raster has
    no Lanczos-4 mode (``ops/render.INTERPS``): such a program renders this
    configuration's LANCZOS on the host, so no operation of the cell would
    run on the card."""
    from feabas_tpu_torch.ops import render as ops_render
    if 'lanczos4' not in getattr(ops_render, 'INTERPS', ()):
        raise SystemExit('align.render renders at LANCZOS on the card; this '
                         "program's mesh raster has no Lanczos-4 mode, so "
                         'it would leave the card idle')


def setup(cell):
    from feabas_tpu_torch.scripts import align_main
    require_lanczos_raster()
    st = State()
    st.cell = cell
    st.d = cell.config['deployment']
    st.p = cell.workload['params']
    st.pool_wd, cfg, st.names, st.drift, _ = align_pool.write_pool(
        cell, st.p['pool'])
    use_config(cfg)
    align_main.main(['--mode', 'meshing'])
    write_tforms(st)
    st.passes = {}
    if unit(st, 0, tag='warm') is None:
        raise RuntimeError('the warm-up section rendered no tile')
    _fsync_tree(cell.work)
    return st


def unit(st, i, tag=None):
    from feabas_tpu_torch.scripts import align_main
    z = i % len(st.names)
    cfg, wd = _pass_dir(st, i // len(st.names) if tag is None else tag)
    use_config(cfg)
    out = os.path.join(wd, 'aligned_stack', 'mip0', f'{z:05d}_{st.names[z]}')
    if os.path.exists(out):
        raise RuntimeError(f'{out} exists before its unit')
    align_main.main(['--mode', 'rendering', '--start', str(z),
                     '--stop', str(z + 1)])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if not os.path.exists(os.path.join(out, 'metadata.txt')):
        return None
    return {'mpx': st.d['section'] ** 2 / 1e6, 'z': z, 'dir': out}


def spans(st):
    from feabas_tpu_torch import common, dal
    from feabas_tpu_torch.renderer import MeshRenderer
    return [(MeshRenderer, 'crop_multiple', 'render.raster'),
            (MeshRenderer, 'crop', 'render.raster'),
            (common, 'imwrite', 'render.encode'),
            (dal.StaticImageLoader, 'crop', 'loader')]


def _tiles(st):
    """[(bbox, file name)] of a section's output tiles: the canvas cut into
    the configuration's tile size, named as the CLI names them."""
    conf = st.cell.config
    r = dict(conf['files']['default_alignment_configs.yaml']['rendering'])
    r.update(conf['overrides']['alignment_configs.yaml'].get('rendering', {}))
    x0, y0, x1, y1 = r['canvas_bbox']
    th, tw = r['tile_size']
    out = []
    for row, ty in enumerate(range(y0, y1, th)):
        for col, tx in enumerate(range(x0, x1, tw)):
            out.append(((tx, ty, tx + tw, ty + th),
                        r['pattern'].format(ROW_IND=row + 1, COL_IND=col + 1)))
    return out


def _section(st, z, dev):
    """Section z as the CLI reads it: its pool tiles, on ``dev``."""
    sec = os.path.join(st.pool_wd, 'stitched_sections', 'mip0', st.names[z])
    with open(os.path.join(sec, 'metadata.txt')) as f:
        rows = [ln.rstrip('\n').split('\t') for ln in f
                if not ln.startswith('{')]
    n = st.d['section']
    img = torch.zeros((n, n), dtype=torch.uint8, device=dev)
    for fname, *b in rows:
        x0, y0, x1, y1 = (int(v) for v in b)
        tile = cv2.imread(os.path.join(sec, fname), cv2.IMREAD_UNCHANGED)
        img[y0:y1, x0:x1] = torch.from_numpy(tile).to(dev)
    return img


def _errors(got, ref, cov, local):
    """(mean |got - ref| over the covered px, the worst mean over the
    ``local`` squares at least half covered; None where none is)."""
    diff = (got.to(torch.float32) - ref.to(torch.float32)).abs() * cov
    mean = float(diff.sum() / cov.sum())
    h, w = diff.shape
    hs, ws = h // local * local, w // local * local

    def squares(a):
        return a[:hs, :ws].reshape(hs // local, local, ws // local,
                                   local).sum(dim=(1, 3))
    n = squares(cov.to(torch.float32))
    full = n >= local * local / 2
    worst = float((squares(diff)[full] / n[full]).max()) if full.any() \
        else None
    return mean, worst


def check(st, units, control=False):
    """The worst tile's and the worst square's mean |difference| over the
    window's units; with ``control``, of the reference computed in
    bfloat16 in the program's place."""
    dev = torch.device('cuda') if torch.cuda.is_available() \
        else torch.device('cpu')
    local = st.cell.workload['reference']['local_px']
    fill = float(st.cell.config['files']['default_alignment_configs.yaml'][
        'rendering']['loader_config']['fillval'])
    prefix = {z: f'{z:05d}_{st.names[z]}' for z in range(len(st.names))}
    worst, worst_local = 0.0, 0.0
    ok = [u for u in units if u['ok']]
    if not ok:
        worst = worst_local = MISSING_LSB
    with ThreadPoolExecutor(8) as pool:
        for z in sorted({u['z'] for u in ok}):
            src = _section(st, z, dev)
            tgt, srcv, tris = st.meshes[z]
            for bbox, pattern in _tiles(st):
                ref, cov = render(src, tgt, srcv, tris, bbox, fill)
                if not bool(cov.any()):
                    continue
                if control:
                    got = [render(src, tgt, srcv, tris, bbox, fill,
                                  torch.bfloat16)[0]] * len(
                        [u for u in ok if u['z'] == z])
                else:
                    files = [os.path.join(u['dir'], prefix[z] + pattern)
                             for u in ok if u['z'] == z]
                    got = list(pool.map(
                        lambda f: cv2.imread(f, cv2.IMREAD_UNCHANGED), files))
                for g in got:
                    if g is None:
                        worst = worst_local = MISSING_LSB
                        continue
                    g = torch.as_tensor(g).to(dev)
                    m, loc = _errors(g, ref, cov, local)
                    worst = max(worst, m)
                    if loc is not None:
                        worst_local = max(worst_local, loc)
            del src
    lim = st.cell.workload['limits']
    return [('render_err_lsb', worst, lim['render_err_lsb']),
            ('render_err_local_lsb', worst_local,
             lim['render_err_local_lsb'])]


def end_to_end(st, units):
    return {}
