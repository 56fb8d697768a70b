"""Zeiss MultiSEM (61/91-beam) specific helpers.

Each mFoV is a hexagonal mosaic of single-beam sFoVs whose relative
positions repeat rigidly across mFoVs. These helpers recover that fixed
beam pattern from intra-mFoV matches and use it to reject deviating matches
and to regularize tiles with no/weak matches (capability parity with
reference ``feabas/multisem.py``).

The port's copy of ``feabas_tpu/multisem.py``, cut to what the port reaches.
"""

import os
from collections import defaultdict
from functools import lru_cache

import numpy as np


def mfovids_beamids_from_filenames(filenames):
    """Parse '{sec}_{mfov}_{beam}_{timestamp}.bmp' names; beams 0-indexed
    (reference: multisem.py:17)."""
    mfovs, beams = [], []
    for fname in filenames:
        parts = os.path.basename(str(fname)).split('_')
        mfovs.append(int(parts[1]))
        beams.append(int(parts[2]) - 1)
    return np.asarray(mfovs), np.asarray(beams)


@lru_cache(maxsize=4)
def beam_coordinate_vectors(beam_num=91):
    """Axial hex coordinates of each beam (0-indexed), spiraling outward
    ring by ring from the center beam; unit vectors are beam0->beam1 (e0)
    and beam0->beam2 (e1) (reference: multisem.py:32)."""
    coords = np.zeros((beam_num, 2))
    # hex spiral: ring r holds 6r beams, walked edge by edge from (r, 0)
    steps = [(-1, 1), (-1, 0), (0, -1), (1, -1), (1, 0), (0, 1)]
    b = 1
    r = 1
    while b < beam_num:
        pt = np.array([r, 0], dtype=float)
        for step in steps:
            for _ in range(r):
                if b >= beam_num:
                    return coords
                coords[b] = pt
                b += 1
                pt = pt + step
        r += 1
    return coords


@lru_cache(maxsize=4)
def beam_neighbors(beam_num=91):
    """Adjacent beam pairs and their hex base-vector (d0, d1)
    (reference: multisem.py:63). Hex distance^2 = d0^2 + d1^2 + d0*d1."""
    c = beam_coordinate_vectors(beam_num)
    d0 = c[None, :, 0] - c[:, None, 0]
    d1 = c[None, :, 1] - c[:, None, 1]
    dis = d0 ** 2 + d1 ** 2 + d0 * d1
    sel = (np.abs(dis - 1) < 1e-6) & ((d0 * 0.5 + d1) > 0)
    b0, b1 = np.nonzero(sel)
    return {(int(a), int(b)): (d0[a, b], d1[a, b]) for a, b in zip(b0, b1)}


def estimate_beam_pattern(matches, beam_num=None):
    """Robust fixed displacement per neighboring beam pair
    (reference: multisem.py:76).

    Args:
        matches: iterable of ((beam0, beam1), (dxy, weight)) intra-mFoV
            displacement observations (dxy = stage offset tile1 - tile0).
    Returns:
        dict {(beam0, beam1): dxy} for all neighbor pairs (including
        unobserved ones, filled from the fitted hex base vectors), or None
        when observations are too sparse.
    """
    matches = list(matches)
    if not matches:
        return None
    if beam_num is None:
        mx = max(max(k[0], k[1]) for k, _ in matches)
        beam_num = 61 if mx < 61 else 91
    nbs = beam_neighbors(beam_num)
    per_pair = defaultdict(list)
    per_base = defaultdict(list)
    for (b0, b1), (dxy, wt) in matches:
        dxy = np.asarray(dxy, np.float64).ravel()
        if (b1, b0) in nbs:
            b0, b1 = b1, b0
            dxy = -dxy
        elif (b0, b1) not in nbs:
            continue
        per_pair[(b0, b1)].append((dxy, wt))
        per_base[nbs[(b0, b1)]].append((dxy, wt))
    if len(per_base) < 2:
        return None
    # weighted LSQ for the two hex base vectors e0, e1:
    # dxy(pair) = d0 * e0 + d1 * e1
    A, B, W = [], [], []
    for (d0, d1), obs in per_base.items():
        for dxy, wt in obs:
            A.append([d0, d1])
            B.append(dxy)
            W.append(wt)
    A = np.asarray(A)
    B = np.asarray(B)
    W = np.asarray(W).reshape(-1, 1)
    try:
        E = np.linalg.lstsq(A * W, B * W, rcond=None)[0]   # (2,2): rows e0,e1
    except np.linalg.LinAlgError:
        return None
    pattern = {}
    for pair, (d0, d1) in nbs.items():
        base = np.array([d0, d1]) @ E
        obs = per_pair.get(pair)
        if obs and len(obs) >= 3:
            # per-pair refinement only with enough observations to vote
            # down outliers; sparse pairs trust the global hex fit
            d = np.asarray([o[0] for o in obs])
            w = np.asarray([o[1] for o in obs])
            keep = w >= np.median(w)
            pattern[pair] = np.median(d[keep], axis=0)
        else:
            pattern[pair] = base
    return pattern


def filter_links_from_sfov_pattern(slm, mfovs, beams, deviation_thresh=4.0,
                                   pseudo_weight=0.2):
    """Discard intra-mFoV links deviating from the beam pattern; add
    pattern-based pseudo-links for neighbor pairs lacking matches
    (reference: multisem.py:147).

    Args:
        slm: the stitching SLM (mesh uid == tile index).
        mfovs, beams: per-tile arrays.
    Returns (num_disabled, num_pseudo).
    """
    from feabas_tpu_torch import constant as const
    mfovs = np.asarray(mfovs)
    beams = np.asarray(beams)
    uid2idx = {m.uid: i for i, m in enumerate(slm.meshes)}
    obs = []
    link_info = []
    for link in slm.active_links():
        i0 = uid2idx[link.uids[0]]
        i1 = uid2idx[link.uids[1]]
        if mfovs[i0] != mfovs[i1]:
            link_info.append((link, None, None))
            continue
        # world equality off0 + p0_local = off1 + p1_local implies the
        # stage displacement off1 - off0 = p0_local - p1_local
        p0 = link.xy0(gear=const.MESH_GEAR_INITIAL) \
            - slm.meshes[i0].offset(const.MESH_GEAR_INITIAL)
        p1 = link.xy1(gear=const.MESH_GEAR_INITIAL) \
            - slm.meshes[i1].offset(const.MESH_GEAR_INITIAL)
        d_obs = np.median(p0 - p1, axis=0).ravel()
        obs.append(((int(beams[i0]), int(beams[i1])),
                    (d_obs, float(np.mean(link.weight())))))
        link_info.append((link, (int(beams[i0]), int(beams[i1])), d_obs))
    pattern = estimate_beam_pattern(obs)
    if pattern is None:
        return 0, 0
    nbs_rev = {(b, a): tuple(-np.asarray(v)) for (a, b), v in pattern.items()}
    full = dict(pattern)
    full.update({k: np.asarray(v) for k, v in nbs_rev.items()})
    n_disabled = 0
    for link, pair, d in link_info:
        if pair is None or pair not in full:
            continue
        if np.linalg.norm(np.asarray(d) - np.asarray(full[pair])) > deviation_thresh:
            link.disable()
            n_disabled += 1
    # pseudo-links: neighbor beam pairs in the same mFoV with no active link
    n_pseudo = 0
    linked = set()
    for link in slm.active_links():
        i0 = uid2idx[link.uids[0]]
        i1 = uid2idx[link.uids[1]]
        linked.add((i0, i1))
        linked.add((i1, i0))
    by_mfov = defaultdict(dict)
    for i, (mf, bm) in enumerate(zip(mfovs, beams)):
        by_mfov[mf][int(bm)] = i
    for mf, beam_map in by_mfov.items():
        for (b0, b1), dxy in pattern.items():
            if b0 not in beam_map or b1 not in beam_map:
                continue
            i0, i1 = beam_map[b0], beam_map[b1]
            if (i0, i1) in linked:
                continue
            m0, m1 = slm.meshes[i0], slm.meshes[i1]
            # pseudo match: the same physical point expressed in both tile
            # frames under the pattern placement off1 - off0 = dxy, i.e.
            # p1_local = p0_local - dxy. Sample 3 points near the shared
            # border midpoint for rotational stability.
            c0 = m0.bbox(gear=const.MESH_GEAR_INITIAL, offsetting=False)
            center0 = np.array([(c0[0] + c0[2]) / 2, (c0[1] + c0[3]) / 2])
            d = np.asarray(dxy, np.float64)
            perp = np.array([-d[1], d[0]])
            nrm = np.linalg.norm(perp)
            perp = perp / nrm * min(nrm / 4, 100) if nrm > 0 else perp
            xy0 = np.stack([center0 + d / 2,
                            center0 + d / 2 + perp,
                            center0 + d / 2 - perp])
            xy1 = xy0 - d
            link = slm.add_link_from_coordinates(
                m0.uid, m1.uid, xy0, xy1,
                weight=np.full(3, pseudo_weight),
                gear=(const.MESH_GEAR_INITIAL, const.MESH_GEAR_INITIAL),
                name=f'pseudo_{mf}_{b0}_{b1}')
            if link.num_matches:
                n_pseudo += 1
    return n_disabled, n_pseudo
