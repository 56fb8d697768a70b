"""Thumbnail matching of section pairs through the thumbnail CLI
(``thumbnail_main --mode matching --start k --stop k+1``), one pair a unit.

Set-up: the seeded stack of ``pool`` turned sections, each written as its
mip-6 thumbnail (a PNG where ``--mode downsample`` writes it) beside a
stitched section's metadata.txt (which names the section; no mip-0 tile is
written or read); one pair matched untimed. The window cycles the CLI's
pair list (every pair at distance 1 to ``compare_distance``); each pass
over it works in a fresh work dir (the thumbnails and metadata linked in,
the matches dir empty), so the CLI never finds a match file it would
skip. A unit's work is one section at mip 0.

Correct: every match file of the window, read back, against the analytic
truth (``reference/thumbnail.py``): at each point of the reference's grid
over the pair's overlap, the error of the match nearest to it (MISSING_PX
where none lies within ``near_px``), thumbnail px; per pair the 95th
percentile; the number compared is the worst pair's.
"""

import os

import numpy as np
import torch

from inputs import thumb_stack
from inputs.align_pool import pass_dir
from inputs.texture import seeds
from inputs.workdir import use_config, write_config, write_pngs
from reference.thumbnail import grid_points, truth_xy0

MISSING_PX = 1000.0
DELIMITER = '__to__'


class State:
    pass


def names(n):
    return [f't{z:04d}' for z in range(n)]


def pairs(n, distance):
    """The CLI's pair list: every pair at distance 1, then 2, ..."""
    return [(i, i + k) for k in range(1, distance + 1) for i in range(n - k)]


def write_pool(cell, n):
    """Make and write the stack; returns (work dir, config folder, section
    names, angles, shifts)."""
    d = cell.config['deployment']
    s_motion, s_tex = seeds(cell.seed, 2)
    angles, shifts = thumb_stack.motions(d, n, s_motion)
    imgs = thumb_stack.sections(cell.dev, d, angles, shifts, s_tex)
    wd = os.path.join(cell.work, 'pool', 'wd')
    sections = names(n)
    jobs = []
    for name, img in zip(sections, imgs):
        sec = os.path.join(wd, 'stitched_sections', 'mip0', name)
        os.makedirs(sec)
        with open(os.path.join(sec, 'metadata.txt'), 'w') as f:
            f.write('{ROOT_DIR}\t' + sec + '\n'
                    + f'{{RESOLUTION}}\t{d["resolution_nm"]}\n')
        jobs.append((os.path.join(wd, 'thumbnail_align', 'thumbnails',
                                  name + '.png'), img))
    write_pngs(jobs)
    cfg = write_config(cell.config, os.path.join(cell.work, 'pool'), wd)
    return wd, cfg, sections, angles, shifts


def _pass_dir(st, tag):
    if tag not in st.passes:
        st.passes[tag] = pass_dir(
            st.cell, st.pool_wd, tag,
            ['stitched_sections', os.path.join('thumbnail_align',
                                               'thumbnails')])
    return st.passes[tag]


def setup(cell):
    st = State()
    st.cell = cell
    st.d = cell.config['deployment']
    st.p = cell.workload['params']
    distance = cell.config['files']['default_thumbnail_configs.yaml'][
        'alignment']['compare_distance']
    st.pool_wd, cfg, st.names, st.angles, st.shifts = write_pool(
        cell, st.p['pool'])
    use_config(cfg)
    st.pairs = pairs(st.p['pool'], distance)
    st.passes = {}
    if unit(st, 0, tag='warm') is None:
        raise RuntimeError('the warm-up pair gave no matches')
    return st


def unit(st, i, tag=None):
    from feabas_tpu_torch.scripts import thumbnail_main
    k = i % len(st.pairs)
    cfg, wd = _pass_dir(st, i // len(st.pairs) if tag is None else tag)
    use_config(cfg)
    z0, z1 = st.pairs[k]
    out = os.path.join(wd, 'thumbnail_align', 'matches',
                       st.names[z0] + DELIMITER + st.names[z1] + '.h5')
    if os.path.exists(out):
        raise RuntimeError(f'{out} exists before its unit')
    thumbnail_main.main(['--mode', 'matching', '--start', str(k),
                         '--stop', str(k + 1)])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if not os.path.exists(out):
        return None
    return {'mpx': st.d['section_px'] ** 2 / 1e6, 'pair': k, 'z0': z0,
            'z1': z1, 'file': out}


def spans(st):
    from feabas_tpu_torch import thumbnail
    return [(thumbnail, 'prepare_image', 'thumbnail.features'),
            (thumbnail, 'match_two_thumbnails_LRadon', 'thumbnail.match'),
            (thumbnail, 'match_two_thumbnails_pmcc', 'thumbnail.refine')]


def matches(st, u):
    """(xy0, xy1) of a unit's match file, thumbnail px."""
    from feabas_tpu_torch.aligner import read_matches_from_h5
    res = st.d['resolution_nm'] * 2 ** st.d['thumbnail_mip_level']
    m = read_matches_from_h5(u['file'], target_resolution=res)
    return np.asarray(m.xy0, np.float64), np.asarray(m.xy1, np.float64)


def errors(st, u, control=False):
    """At each point of the reference's grid over the pair's overlap, the
    error of the match nearest to it, thumbnail px (MISSING_PX where none
    lies within ``near_px``)."""
    from scipy.spatial import cKDTree
    xy0, xy1 = matches(st, u)
    size, z0, z1 = st.d['thumbnail'], u['z0'], u['z1']
    xy0 = torch.as_tensor(xy0)
    if control:
        xy0 = truth_xy0(size, st.angles, st.shifts, z0, z1, xy1,
                        torch.bfloat16).to(torch.float64)
    err = torch.linalg.norm(
        xy0 - truth_xy0(size, st.angles, st.shifts, z0, z1, xy1),
        dim=1).numpy()
    ref = st.cell.workload['reference']
    q = grid_points(size, st.angles, st.shifts, z0, z1, ref['pitch_px'],
                    ref['margin_px']).numpy()
    dist, k = cKDTree(xy1).query(q)
    at_q = err[np.minimum(k, len(err) - 1)]
    at_q[dist > ref['near_px']] = MISSING_PX
    return at_q


def end_to_end(st, units):
    return {}


def check(st, units, control=False):
    worst = MISSING_PX
    per = [errors(st, u, control) for u in units if u['ok']]
    if per:
        worst = max(float(np.percentile(e, 95)) for e in per)
    return [('match_err_p95_px', worst,
             st.cell.workload['limits']['match_err_p95_px'])]
