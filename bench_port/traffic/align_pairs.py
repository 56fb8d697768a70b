"""Fine matching of neighbouring section pairs through the align CLI
(``align_main --mode matching --start j --stop j+1``), one pair a unit.

Set-up: the seeded stack of ``pool`` sections, written as stitched
sections (uncompressed PNG tiles and metadata.txt), meshed by the CLI's
meshing; one pair matched untimed. The window cycles the pool's
neighbouring pairs; each pass over them works in a fresh work dir (the
stack and meshes linked in, the matches dir empty), so the driver never
finds a match file it would skip. A unit's work is one section at mip 0.

Correct: every match file of the window, read back, against the analytic
truth (``reference/align.py``): at each point of the reference's grid over
the pair's overlap, the error of the match nearest to it (MISSING_PX where
none lies within ``near_px`` working px), mip-0 px; per pair the 95th
percentile; the number compared is the worst pair's.
"""

import os

import numpy as np
import torch

from inputs import align_pool
from inputs.workdir import use_config
from reference.align import grid_points, truth_xy0

MISSING_PX = 1000.0


class State:
    pass


def _pass_dir(st, tag):
    if tag not in st.passes:
        st.passes[tag] = align_pool.pass_dir(
            st.cell, st.pool_wd, tag,
            [os.path.join('stitched_sections'), os.path.join('align', 'mesh')])
    return st.passes[tag]


def setup(cell):
    from feabas_tpu_torch.scripts import align_main
    st = State()
    st.cell = cell
    st.d = cell.config['deployment']
    st.p = cell.workload['params']
    st.scale = 2 ** cell.config['overrides']['alignment_configs.yaml'][
        'matching']['working_mip_level']
    st.pool_wd, cfg, st.names, st.drift, _ = align_pool.write_pool(
        cell, st.p['pool'])
    use_config(cfg)
    align_main.main(['--mode', 'meshing'])
    st.passes = {}
    st.npairs = st.p['pool'] - 1
    if unit(st, 0, tag='warm') is None:
        raise RuntimeError('the warm-up pair gave no matches')
    return st


def unit(st, i, tag=None):
    from feabas_tpu_torch.aligner import match_name
    from feabas_tpu_torch.scripts import align_main
    j = i % st.npairs
    cfg, wd = _pass_dir(st, i // st.npairs if tag is None else tag)
    use_config(cfg)
    out = os.path.join(wd, 'align', 'matches',
                       match_name(st.names[j], st.names[j + 1]))
    if os.path.exists(out):
        raise RuntimeError(f'{out} exists before its unit')
    align_main.main(['--mode', 'matching', '--start', str(j),
                     '--stop', str(j + 1)])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if not os.path.exists(out):
        return None
    return {'mpx': st.d['section'] ** 2 / 1e6, 'pair': j, 'file': out}


def spans(st):
    from feabas_tpu_torch import matcher
    from feabas_tpu_torch.scripts import align_main
    return [(matcher, 'section_matcher', 'matcher'),
            (align_main, '_maybe_stream', 'loader')]


def _errors(st, u, control=False):
    """(each match's error, mip-0 px; at each point of the reference's
    grid the error vector of the match nearest to it, mip-0 px, NaN where
    none lies within ``near_px``; the points, working px of the pair's
    second section)."""
    from feabas_tpu_torch.aligner import read_matches_from_h5
    from scipy.spatial import cKDTree
    m = read_matches_from_h5(u['file'])
    z0, z1 = u['pair'], u['pair'] + 1
    xy0 = torch.as_tensor(m.xy0, dtype=torch.float64)
    if control:
        xy0 = truth_xy0(st.d, st.drift, z0, z1, m.xy1, st.scale,
                        torch.bfloat16).to(torch.float64)
    truth = truth_xy0(st.d, st.drift, z0, z1, m.xy1, st.scale)
    vec = (st.scale * (xy0 - truth)).numpy()
    ref = st.cell.workload['reference']
    q = grid_points(st.d, st.drift, z0, z1, st.scale, ref['pitch_px'],
                    ref['margin_px']).numpy()
    dist, k = cKDTree(np.asarray(m.xy1)).query(q)
    at_q = vec[np.minimum(k, len(vec) - 1)]
    at_q[dist > ref['near_px']] = np.nan
    return np.linalg.norm(vec, axis=1), at_q, q


def end_to_end(st, units):
    errs = [_errors(st, u)[0] for u in units if u['ok']]
    return {'err_px_p95': float(np.percentile(np.concatenate(errs), 95))}


def check(st, units, control=False):
    worst = MISSING_PX
    per = [_errors(st, u, control)[1] for u in units if u['ok']]
    if per:
        worst = max(float(np.percentile(np.nan_to_num(
            np.linalg.norm(e, axis=1), nan=MISSING_PX), 95)) for e in per)
    return [('match_err_p95_px', worst,
             st.cell.workload['limits']['match_err_p95_px'])]
