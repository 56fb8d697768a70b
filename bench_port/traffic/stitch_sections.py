"""Whole sections through the stitch CLI, one a unit: ``stitch_main``
matching, optimization and rendering, each filtered to the section.

Set-up: ``pool`` seeded sections (a world texture and a jitter each) cut
into their tiles, written as PNG with one coordinate file a section; one
section stitched untimed. The window cycles the pool; each pass over it
works in a fresh work dir (coordinate files only), so the driver never
finds an output it would skip. A unit's work is the section's raw tile
pixels.

Correct, for every section the window stitched (the render for a sample
of them, drawn from the seed), against the reference
(``reference/stitch.py``):
- matches: at each point of a grid over each expected overlap, the error
  of the match nearest to it (MISSING_PX where none lies within
  ``near_px``, so an overlap left unmatched fails); the overlap's 95th
  percentile, the worst overlap's compared;
- placements: the worst tile's distance from its true position (up to the
  section's translation);
- the blend: per output block, the |difference| from the world sampled
  where the canvas puts each pixel, over the pixels 3 px inside a true
  tile: its mean (``render_err_lsb``), and its mean over each square of
  ``local_px`` with half its pixels or more compared
  (``render_err_local_lsb``, which a fault in a small part of a block
  cannot hide in the block's mean); the worst block's and square's.
"""

import os

import numpy as np
import torch

from inputs import stitch_grid
from inputs.texture import seeds
from inputs.workdir import read_rendered, use_config, write_config, write_pngs
from reference.stitch import (canvas, expected_overlaps, match_world_error,
                              overlap_points, placement_errors)

MISSING_PX = 1000.0
BLOCK = 2048


class State:
    pass


def _coord_lines(tdir, stage_bb, res):
    lines = ['{ROOT_DIR}\t' + tdir, f'{{RESOLUTION}}\t{res}']
    for k, sb in enumerate(stage_bb):
        lines.append(f'tile_{k:03d}.png\t{sb[0]:.0f}\t{sb[1]:.0f}\t'
                     f'{sb[2]:.0f}\t{sb[3]:.0f}')
    return '\n'.join(lines) + '\n'


def _pass_dir(st, tag):
    if tag not in st.passes:
        root = os.path.join(st.cell.work, f'pass_{tag}')
        wd = os.path.join(root, 'wd')
        cdir = os.path.join(wd, 'stitch', 'stitch_coord')
        os.makedirs(cdir)
        for s in st.sections:
            with open(os.path.join(cdir, s['name'] + '.txt'), 'w') as f:
                f.write(s['coord'])
        st.passes[tag] = (write_config(st.cell.config, root, wd), wd)
    return st.passes[tag]


def setup(cell):
    st = State()
    st.cell = cell
    d = cell.config['deployment']
    st.d = d
    pool = cell.workload['params']['pool']
    sd = seeds(cell.seed, 2 * pool)
    st.sections = []
    for k in range(pool):
        world = stitch_grid.make_world(cell.dev, d, sd[2 * k])
        true_bb, stage_bb = stitch_grid.layout(d, sd[2 * k + 1])
        name = f'section{k:02d}'
        tdir = os.path.join(cell.work, 'pool', 'raw', name)
        write_pngs([(os.path.join(tdir, f'tile_{i:03d}.png'), t)
                    for i, t in enumerate(stitch_grid.tiles(world, true_bb))])
        st.sections.append({'name': name, 'world': world, 'true_bb': true_bb,
                            'stage_bb': stage_bb,
                            'coord': _coord_lines(tdir, stage_bb,
                                                  d['resolution_nm'])})
    st.passes = {}
    st.mpx = d['rows'] * d['cols'] * d['tile_h'] * d['tile_w'] / 1e6
    if unit(st, 0, tag='warm') is None:
        raise RuntimeError('the warm-up section was not stitched')
    return st


def unit(st, i, tag=None):
    from feabas_tpu_torch.scripts import stitch_main
    k = i % len(st.sections)
    name = st.sections[k]['name']
    cfg, wd = _pass_dir(st, i // len(st.sections) if tag is None else tag)
    outs = {'match': os.path.join(wd, 'stitch', 'match_h5', name + '.h5'),
            'tform': os.path.join(wd, 'stitch', 'tform', name + '.h5'),
            'render': os.path.join(wd, 'stitched_sections', 'mip0', name)}
    if any(os.path.exists(p) for p in outs.values()):
        raise RuntimeError(f'an output of {name} exists before its unit')
    for mode in ('matching', 'optimization', 'rendering'):
        use_config(cfg)
        stitch_main.main(['--mode', mode, '--filter', name])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if not (os.path.exists(outs['match']) and os.path.exists(outs['tform'])
            and os.path.exists(os.path.join(outs['render'], 'metadata.txt'))):
        return None
    return {'mpx': st.mpx, 'section': k, **outs}


def spans(st):
    from feabas_tpu_torch.stitcher import MontageRenderer, Stitcher
    out = [(Stitcher, 'dispatch_matchers', 'matcher'),
           (MontageRenderer, 'render_series_to_file', 'blender')]
    for attr in ('optimize_translation', 'optimize_affine',
                 'optimize_group_intersection', 'optimize_elastic'):
        out.append((Stitcher, attr, 'solver'))
    return out


def _match_errors(st, u, control=False):
    """(each match's error, each expected overlap's reference errors)."""
    from feabas_tpu_torch.stitcher import Stitcher
    from scipy.spatial import cKDTree
    s = st.sections[u['section']]
    tb = s['true_bb']
    ref = st.cell.workload['reference']
    matches = Stitcher.from_h5(u['match'], load_meshes=False).matches
    every, per_overlap = [], []
    for i, j in expected_overlaps(s['stage_bb'], ref['min_overlap_px']):
        m = matches.get((i, j))
        xy0, xy1, a, b = (None, None, i, j) if m is None else (m.xy0, m.xy1, i, j)
        if m is None and (j, i) in matches:
            m = matches[(j, i)]
            xy0, xy1, a, b = m.xy0, m.xy1, j, i
        q = overlap_points(tb, i, j, ref['pitch_px'], ref['margin_px'])
        if m is None or len(xy0) == 0:
            per_overlap.append(np.full(len(q), MISSING_PX))
            continue
        if control:
            # the reference in the program's place, in bfloat16: the
            # partner of each xy1 computed from the true offsets
            x = torch.as_tensor(xy1).to(torch.bfloat16) + torch.as_tensor(
                tb[b][:2] - tb[a][:2]).to(torch.bfloat16)
            xy0 = x.to(torch.float64).numpy()
        err = match_world_error(xy0, xy1, tb[a], tb[b])
        every.append(err)
        dist, k = cKDTree(np.asarray(xy0) + tb[a][:2]).query(q)
        per_overlap.append(np.where(dist <= ref['near_px'], err[k], MISSING_PX))
    return every, per_overlap


def _placed(st, u):
    """Placed tile origins (N, 2): each tile mesh's mean vertex move."""
    from feabas_tpu_torch.stitcher import Stitcher
    meshes = Stitcher.from_h5(u['tform']).meshes
    return np.asarray([m.vertices_w_offset('MOVING').mean(axis=0)
                       - m.vertices_w_offset('INITIAL').mean(axis=0)
                       for m in meshes])


def _render_diffs(st, u, g, control=False):
    """(|rendered - reference| (LSB), compared) of each block of BLOCK px
    over the canvas the true tiles span once moved by g (a block the
    program did not write reads as zeros)."""
    s = st.sections[u['section']]
    tb = s['true_bb']
    x0, y0 = (int(np.floor(v)) for v in tb[:, :2].min(axis=0) + g)
    x1, y1 = (int(np.ceil(v)) for v in tb[:, 2:].max(axis=0) + g)
    for by in range(y0, y1, BLOCK):
        for bx in range(x0, x1, BLOCK):
            bb = (bx, by, min(bx + BLOCK, x1), min(by + BLOCK, y1))
            want, seen = canvas(s['world'], tb, g, bb)
            if control:
                got, _ = canvas(s['world'], tb, g, bb, dtype=torch.bfloat16)
            else:
                img = read_rendered(u['render'], bb)
                got = torch.as_tensor(img, device=want.device).to(torch.float32)
            yield (got - want).abs(), seen


def square_sums(diff, seen, side):
    """(sum of |diff| over the compared pixels, their count) of each square
    of ``side`` px of a block, from its top left corner."""
    h, w = diff.shape
    pad = (0, -w % side, 0, -h % side)
    d = torch.nn.functional.pad(torch.where(seen, diff, 0.0), pad)
    c = torch.nn.functional.pad(seen.to(torch.float32), pad)
    shape = (d.shape[0] // side, side, d.shape[1] // side, side)
    return d.reshape(shape).sum((1, 3)), c.reshape(shape).sum((1, 3))


def _render_errors(st, u, g, control=False):
    """(the worst block's mean |difference|, the worst square's)."""
    side = st.cell.workload['reference']['local_px']
    block, square = 0.0, 0.0
    for diff, seen in _render_diffs(st, u, g, control):
        if int(seen.sum()):
            block = max(block, float(diff[seen].mean()))
            d, c = square_sums(diff, seen, side)
            half = c >= side * side / 2
            if bool(half.any()):
                square = max(square, float((d[half] / c[half]).max()))
    return block, square


def end_to_end(st, units):
    errs = [e for u in units if u['ok'] for e in _match_errors(st, u)[0]]
    return {'err_px_p95': float(np.percentile(np.concatenate(errs), 95))}


def render_sample(st, ok):
    """Which of the window's stitched sections have their blend compared:
    ``render_checked`` of them, drawn from the seed."""
    if not ok:
        return set()
    rng = np.random.default_rng(seeds(st.cell.seed, 1)[0])
    return set(rng.choice(len(ok), min(len(ok), st.cell.workload['params'][
        'render_checked']), replace=False).tolist())


def canvas_offset(st, u, control=False):
    """g, and the worst tile's distance from true + g, of a stitched
    section (with ``control``, of the true placements rounded to
    bfloat16)."""
    placed = _placed(st, u)
    tb = st.sections[u['section']]['true_bb']
    if control:
        g0, _ = placement_errors(placed, tb)
        placed = (torch.as_tensor(tb[:, :2] + g0).to(torch.bfloat16)
                  .to(torch.float64).numpy())
    return placement_errors(placed, tb)


def check(st, units, control=False):
    lim = st.cell.workload['limits']
    ok = [u for u in units if u['ok']]
    sample = render_sample(st, ok)
    match, place, render, local = 0.0, 0.0, 0.0, 0.0
    for n, u in enumerate(ok):
        per = _match_errors(st, u, control)[1]
        match = max([match] + [float(np.percentile(p, 95)) for p in per])
        g, perr = canvas_offset(st, u, control)
        place = max(place, float(perr.max()))
        if n in sample:
            r, q = _render_errors(st, u, g, control)
            render, local = max(render, r), max(local, q)
    if not ok:
        match = place = render = local = MISSING_PX
    return [('match_err_p95_px', match, lim['match_err_p95_px']),
            ('place_err_px', place, lim['place_err_px']),
            ('render_err_lsb', render, lim['render_err_lsb']),
            ('render_err_local_lsb', local, lim['render_err_local_lsb'])]
