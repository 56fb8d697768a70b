"""Template matching through deforming meshes (counterpart of
``feabas_tpu/matcher.py``).

`stitching_matcher` seeds a placement (the stage prior with the
in-program coarse seed, or the host global translation), then runs the
coarse-to-fine block schedule: the fused one-program schedule
(``ops.match_loop``) when it applies, else the classic per-round loop
(device warp or rendered blocks + xcorr, host SLM relaxation).
`match_pairs_batched` runs same-shape pairs as one batched fused program;
`section_matcher` matches two sections of a serial stack, piece by piece
when a section is cut into disconnected parts.

All device work happens on ``device`` (``device.get_device``); errors of
the device, a kernel or a shape propagate. Only the algorithmic
reroutes of the JAX package remain: a prep or finalize that returns None,
or an overlap under 256 px, takes the classic path.
"""

import numpy as np
import torch

from feabas_tpu_torch import common, config
from feabas_tpu_torch import constant as const
from feabas_tpu_torch.dal import StreamLoader
from feabas_tpu_torch.mesh import Mesh
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch import state
from feabas_tpu_torch.ops import match_loop
from feabas_tpu_torch.ops import warp as warp_ops
from feabas_tpu_torch.ops.xcorr import good_fft_size, xcorr_fft
from feabas_tpu_torch.optimizer import SLM

# pairs per batched fused program on one GPU
MAX_BATCH = 8


def _env_interior(origins, bs, K, A, b, vhw):
    """Per-block flag: the whole source read window of the shifted warp
    (affine images of the block corners +- (K+4)) lies inside the source's
    valid-content extents (h, w)."""
    corners = np.array([[0, 0], [bs, 0], [0, bs], [bs, bs]], np.float64)
    c = origins[:, None, :] + corners[None]
    sxy = np.einsum('bcx,bxy->bcy', c, np.asarray(A, np.float64)) \
        + np.asarray(b, np.float64)[:, None, :]
    lo = sxy.min(axis=1) - (K + 4)
    hi = sxy.max(axis=1) + (K + 4)
    h, w = int(vhw[0]), int(vhw[1])
    return ((lo[:, 0] >= 0) & (lo[:, 1] >= 0)
            & (hi[:, 0] <= w) & (hi[:, 1] <= h))


def _parse_subpixel(kwargs):
    """Final-round subpixel mode from ``subpixel_upsample``: int >= 2 ->
    normalized local-DFT upsampling; 1/True -> 3x3 quadratic (default);
    0/False -> integer peaks."""
    sp_up = kwargs.get('subpixel_upsample', 1)
    sp_up = int(sp_up) if sp_up else 0
    return sp_up if sp_up >= 2 else bool(sp_up)


def global_translation_matcher(img0, img1, device=None, **kwargs):
    """Whole-image translation via FFT xcorr; falls back to divided blocks
    when confidence is low."""
    sigma = kwargs.get('sigma', 0.0)
    mask0 = kwargs.get('mask0', None)
    mask1 = kwargs.get('mask1', None)
    conf_mode = kwargs.get('conf_mode', const.FFT_CONF_MIRROR)
    conf_thresh = kwargs.get('conf_thresh', 0.3)
    divide_factor = kwargs.get('divide_factor', 6)
    dev = device_mod.get_device(device)
    dx, dy, conf = xcorr_fft(img0, img1, conf_mode=conf_mode, device=dev,
                             sigma=sigma, mask0=mask0, mask1=mask1, pad=True,
                             subpixel=False)
    dx, dy, conf = float(dx), float(dy), float(conf)
    if conf >= conf_thresh:
        return dx, dy, conf
    # low confidence: divide the larger image into blocks and let the
    # highest-confidence block vote the translation
    shp0, shp1 = img0.shape[-2:], img1.shape[-2:]
    swap = shp1[0] * shp1[1] > shp0[0] * shp0[1] * 1.5
    if swap:
        img0, img1 = img1, img0
        shp0, shp1 = shp1, shp0
    if min(shp0[0], shp0[1]) // divide_factor < 32:
        return dx, dy, conf
    bx = max(shp0[1] // divide_factor, 32)
    by = max(shp0[0] // divide_factor, 32)
    x0s, y0s, x1s, y1s = common.divide_bbox((0, 0, shp0[1], shp0[0]),
                                            block_size=(by, bx))
    blocks0, origins = [], []
    for xa, ya, xb, yb in zip(x0s, y0s, x1s, y1s):
        blocks0.append(img0[ya:yb, xa:xb])
        origins.append((xa, ya))
    hmin = min(b.shape[0] for b in blocks0)
    wmin = min(b.shape[1] for b in blocks0)
    stack0 = np.stack([b[:hmin, :wmin] for b in blocks0])
    stack1 = np.ascontiguousarray(
        np.broadcast_to(img1, (len(blocks0),) + tuple(shp1)))
    dxs, dys, confs = xcorr_fft(stack0, stack1, conf_mode=conf_mode,
                                device=dev, sigma=sigma, pad=True)
    best = int(np.argmax(confs))
    if confs[best] <= conf:
        return dx, dy, conf
    xa, ya = origins[best]
    cx = xa + wmin / 2
    cy = ya + hmin / 2
    dx_adj = float(dxs[best]) + (shp0[1] / 2 - cx)
    dy_adj = float(dys[best]) + (shp0[0] / 2 - cy)
    if swap:
        return -dx_adj, -dy_adj, float(confs[best])
    return dx_adj, dy_adj, float(confs[best])


def distributor_cartesian_bbox(bbox, spacing, block_size,
                               min_boundary_distance=0):
    """Block centres on a cartesian grid covering bbox. Returns (N, 2)."""
    x0, y0, x1, y1 = bbox
    x0 += min_boundary_distance
    y0 += min_boundary_distance
    x1 -= min_boundary_distance
    y1 -= min_boundary_distance
    if x1 <= x0 or y1 <= y0:
        return np.zeros((0, 2))
    nx = max(int(np.round((x1 - x0) / spacing)), 1)
    ny = max(int(np.round((y1 - y0) / spacing)), 1)
    xs = np.linspace(x0 + (x1 - x0) / (2 * nx), x1 - (x1 - x0) / (2 * nx), nx)
    ys = np.linspace(y0 + (y1 - y0) / (2 * ny), y1 - (y1 - y0) / (2 * ny), ny)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel()], axis=-1)


def _coverage_grids(mesh0, mesh1, bbox, cell, gear=const.MESH_GEAR_MOVING):
    """Coarse occupancy grids of both meshes over bbox (cell px per
    sample): (inside0, inside1, tid0, tid1, xs, ys) -- boolean grids, the
    covering triangle per cell (-1 outside) and the cell-centre world
    coordinates."""
    x0, y0, x1, y1 = bbox
    xs = np.arange(x0 + cell / 2, x1, cell)
    ys = np.arange(y0 + cell / 2, y1, cell)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], -1)
    tid0 = mesh0.tri_finder(pts, gear=gear).reshape(gy.shape)
    tid1 = mesh1.tri_finder(pts, gear=gear).reshape(gy.shape)
    return tid0 >= 0, tid1 >= 0, tid0, tid1, xs, ys


def _refine_material_masks(mesh, tid_grid):
    """{area_constraint: bool grid} of the materials that ask for denser
    blocks (area_constraint in (0, 1), or named 'refine*') on the coarse
    occupancy grid."""
    out = {}
    inside = tid_grid >= 0
    if not inside.any():
        return out
    mat_of_cell = np.full(tid_grid.shape, -1, np.int32)
    mat_of_cell[inside] = mesh.material_ids[tid_grid[inside]]
    for name, mat in mesh.material_table:
        af = float(getattr(mat, 'area_constraint', 1.0))
        if not ('refine' in str(name) or (0 < af < 1)):
            continue
        if not (0 < af < 1):
            af = 0.5
        sel = mat_of_cell == mat.uid
        if sel.any():
            grid = out.setdefault(af, np.zeros(tid_grid.shape, bool))
            grid |= sel
    return out


def _grid_points_in_mask(mask, spacing_cells, xs, ys, triangular=False):
    """Sample points every ``spacing_cells`` grid cells whose cell lies in
    ``mask``, anchored at the mask centroid (hex-packed rows when
    ``triangular``); world coordinates (N, 2)."""
    ii, jj = np.nonzero(mask)
    if ii.size == 0:
        return np.zeros((0, 2))
    ci, cj = ii.mean(), jj.mean()
    step = max(spacing_cells, 1.0)
    if triangular:
        dy = step * np.sqrt(3) / 2
        rows = np.concatenate([np.arange(ci, -dy, -dy)[::-1],
                               np.arange(ci + dy, mask.shape[0], dy)])
        pts = []
        for k, r in enumerate(rows):
            off = (step / 2) if (k % 2) else 0.0
            cols = np.concatenate([np.arange(cj + off, -step, -step)[::-1],
                                   np.arange(cj + off + step, mask.shape[1],
                                             step)])
            pts.append(np.stack([np.full(cols.shape, r), cols], -1))
        rc = np.concatenate(pts) if pts else np.zeros((0, 2))
    else:
        rr = np.concatenate([np.arange(ci, -step, -step)[::-1],
                             np.arange(ci + step, mask.shape[0], step)])
        cc = np.concatenate([np.arange(cj, -step, -step)[::-1],
                             np.arange(cj + step, mask.shape[1], step)])
        gr, gc = np.meshgrid(rr, cc, indexing='ij')
        rc = np.stack([gr.ravel(), gc.ravel()], -1)
    ri = np.clip(np.round(rc[:, 0]).astype(int), 0, mask.shape[0] - 1)
    ci_ = np.clip(np.round(rc[:, 1]).astype(int), 0, mask.shape[1] - 1)
    rc = rc[mask[ri, ci_]]
    return np.stack([np.interp(rc[:, 1], np.arange(xs.size), xs),
                     np.interp(rc[:, 0], np.arange(ys.size), ys)], -1)


def distribute_matching_blocks(mesh0, mesh1, spacing,
                               distributor='cartesian_region', **kwargs):
    """Region/material-aware block centres: blocks only where both meshes
    have coverage, ``min_boundary_distance`` eroded from the true region
    boundary, materials below the render-weight / stiffness thresholds
    excluded, and materials flagged for refinement given denser, smaller
    blocks. 'cartesian_region' puts them on a grid, 'intersect_triangulation'
    hex-packs them. Returns (centres (N, 2), size_factor (N,)); a block's
    side is ``spacing * shrink_factor * size_factor``."""
    gear = kwargs.get('gear', const.MESH_GEAR_MOVING)
    min_boundary_distance = kwargs.get('min_boundary_distance', 0)
    refine_box_exp = kwargs.get('refine_box_exp', 0.5)
    refine_mode = kwargs.get('refine_mode', 2)
    render_weight_threshold = kwargs.get('render_weight_threshold', 0)
    stiffness_multiplier_threshold = kwargs.get(
        'stiffness_multiplier_threshold', 0)
    triangular = (str(distributor).lower() == 'intersect_triangulation')
    ovl, valid = common.intersect_bbox(mesh0.bbox(gear=gear),
                                       mesh1.bbox(gear=gear))
    if not valid:
        return np.zeros((0, 2)), np.zeros(0)
    cell = max(min(spacing / 4.0, (ovl[2] - ovl[0]) / 8.0,
                   (ovl[3] - ovl[1]) / 8.0), 1.0)
    in0, in1, tid0, tid1, xs, ys = _coverage_grids(mesh0, mesh1, ovl, cell,
                                                   gear=gear)
    inter = in0 & in1
    if render_weight_threshold > 0 or stiffness_multiplier_threshold > 0:
        for msh, tg, ins in ((mesh0, tid0, in0), (mesh1, tid1, in1)):
            bad_uids = set()
            for uid, mat in msh.material_table.uid_to_material().items():
                rw = mat.render_weight if mat.render else 0.0
                if render_weight_threshold > 0 and rw < render_weight_threshold:
                    bad_uids.add(int(uid))
                if (stiffness_multiplier_threshold > 0
                        and mat.stiffness_multiplier
                        < stiffness_multiplier_threshold):
                    bad_uids.add(int(uid))
            if not bad_uids:
                continue
            mat_cell = np.full(tg.shape, -9, np.int32)
            mat_cell[ins] = msh.material_ids[tg[ins]]
            inter &= ~np.isin(mat_cell, list(bad_uids))
    if not inter.any():
        return np.zeros((0, 2)), np.zeros(0)
    eroded = inter
    if min_boundary_distance > 0:
        from scipy.ndimage import distance_transform_edt
        d = distance_transform_edt(inter) * cell
        eroded = d >= min_boundary_distance
        # keep at least half the region: relax the erosion when it eats more
        if eroded.sum() < 0.5 * inter.sum():
            eroded = d >= min_boundary_distance * 0.3
        if not eroded.any():
            eroded = inter
    layers = {}
    if refine_mode != 0:
        for msh, tg in ((mesh0, tid0), (mesh1, tid1)):
            for af, grid in _refine_material_masks(msh, tg).items():
                acc = layers.setdefault(af, np.zeros(inter.shape, bool))
                acc |= grid
    centers, factors = [], []
    covered = np.zeros(inter.shape, bool)
    for af in sorted(layers):
        mask = layers[af] & eroded & (~covered)
        pts = _grid_points_in_mask(mask, af * spacing / cell, xs, ys,
                                   triangular=triangular)
        if pts.shape[0]:
            centers.append(pts)
            factors.append(np.full(pts.shape[0], af ** refine_box_exp))
        covered |= layers[af] & inter
    base = eroded if refine_mode != 1 else (eroded & covered)
    base_mask = base & (~covered) if refine_mode == 2 else base
    if refine_mode != 1 or not layers:
        pts = _grid_points_in_mask(base_mask if layers else eroded,
                                   spacing / cell, xs, ys,
                                   triangular=triangular)
        if pts.shape[0]:
            centers.append(pts)
            factors.append(np.ones(pts.shape[0]))
    if not centers:
        return np.zeros((0, 2)), np.zeros(0)
    return np.concatenate(centers), np.concatenate(factors)


def _block_centers(mesh0, mesh1, spacing, shrink_factor,
                   min_boundary_distance, kwargs):
    """Block centres and size factors of one round, from the configured
    distributor; None when the meshes do not overlap."""
    distributor = str(kwargs.get('distributor', 'cartesian_bbox')).lower()
    if distributor in ('cartesian_region', 'intersect_triangulation'):
        return distribute_matching_blocks(
            mesh0, mesh1, spacing, distributor=distributor,
            min_boundary_distance=min_boundary_distance,
            shrink_factor=shrink_factor,
            render_weight_threshold=kwargs.get('render_weight_threshold', 0),
            stiffness_multiplier_threshold=kwargs.get(
                'stiffness_multiplier_threshold', 0))
    ovl, valid = common.intersect_bbox(mesh0.bbox(gear=const.MESH_GEAR_MOVING),
                                       mesh1.bbox(gear=const.MESH_GEAR_MOVING))
    if not valid:
        return None
    centers = distributor_cartesian_bbox(
        ovl, spacing, spacing * shrink_factor,
        min_boundary_distance=min_boundary_distance)
    return centers, np.ones(centers.shape[0])


_BLOCK_SIZES = np.array([16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512])


def _quantize_block(size):
    """Round block sizes up to a small set of shapes."""
    size = int(round(size))
    i = int(np.searchsorted(_BLOCK_SIZES, size))
    return int(_BLOCK_SIZES[min(i, len(_BLOCK_SIZES) - 1)])


def _pad_pow2(n, lo=8):
    return max(lo, 1 << (int(n - 1).bit_length()))


def _fused_prep(mesh0, mesh1, loader0, loader1, spacings, **kwargs):
    """Host-side planning for the fused fine-match schedule: block
    lattices, triangle assignments, affines, element data. Returns a prep
    dict of HOST arrays (stackable across pairs) or None when the fused
    case does not apply."""
    sigma = kwargs.get('sigma', 2.5)
    conf_thresh = kwargs.get('conf_thresh', 0.3)
    shrink_factor = kwargs.get('shrink_factor', 1.0)
    residue_len = kwargs.get('residue_len', 3)
    stiffness_lambda = kwargs.get('stiffness_lambda', -0.35)
    min_boundary_distance = kwargs.get('min_boundary_distance', 0)
    min_num_blocks = kwargs.get('min_num_blocks', 2)
    compute_strain = kwargs.get('compute_strain', True)
    if stiffness_lambda >= 0:
        return None
    groups = mesh1.element_arrays(gear=const.MESH_GEAR_FIXED)
    groups0 = mesh0.element_arrays(gear=const.MESH_GEAR_FIXED)
    if any(g['model'] != const.MATERIAL_MODEL_ENG or g['knots'] is not None
           for g in list(groups) + list(groups0)):
        return None
    bbox0 = mesh0.bbox(gear=const.MESH_GEAR_MOVING)
    bbox1 = mesh1.bbox(gear=const.MESH_GEAR_MOVING)
    ovl, valid_b = common.intersect_bbox(bbox0, bbox1)
    if not valid_b:
        return None
    A0_all, b0_all = mesh0.triangle_affine_tform(
        gear0=const.MESH_GEAR_MOVING, gear1=const.MESH_GEAR_INITIAL)
    A1p, _b1p = mesh1.triangle_affine_tform(
        gear0=const.MESH_GEAR_MOVING, gear1=const.MESH_GEAR_INITIAL)
    off0 = np.asarray(loader0._offset, np.float64)
    off1 = np.asarray(loader1._offset, np.float64)
    spacings = np.asarray(sorted(np.atleast_1d(spacings).astype(np.float64),
                                 reverse=True))
    rounds = []
    meta = []
    valid_rounds = []
    first = True
    has_last = False
    for i, spacing in enumerate(spacings):
        last = i == len(spacings) - 1
        centers, size_factors = _block_centers(
            mesh0, mesh1, spacing, shrink_factor, min_boundary_distance,
            kwargs)
        if centers.shape[0] and not np.allclose(size_factors, 1.0):
            # refine-material blocks of several sizes: one block shape per
            # round is the fused program's premise
            return None
        if centers.shape[0] == 0 or (centers.shape[0] < min_num_blocks
                                     and not last):
            continue
        tid0 = mesh0.tri_finder(centers, gear=const.MESH_GEAR_MOVING,
                                extrapolate=False)
        tid1 = mesh1.tri_finder(centers, gear=const.MESH_GEAR_MOVING,
                                extrapolate=False)
        keep = (tid0 >= 0) & (tid1 >= 0)
        if not keep.any():
            continue
        centers = centers[keep]
        tid0 = tid0[keep]
        tid1 = tid1[keep]
        bs = _quantize_block(max(spacing * shrink_factor, 16.0))
        A0 = A0_all[tid0]
        b0 = b0_all[tid0] - off0
        anchor_idx = mesh1.triangles[tid1]
        origins = np.round(centers - bs / 2.0)
        n = centers.shape[0]
        nb = _pad_pow2(n)
        valid = np.zeros(nb, np.float32)
        valid[:n] = 1.0

        def _pad(a):
            if nb == n:
                return a
            return np.concatenate([a, np.repeat(a[:1], nb - n, axis=0)])

        rlen = residue_len if residue_len > 0 else max(spacing * 0.1, 2.0)
        fs = good_fft_size(2 * bs - 1, pow2=True)
        # shifted-warp window bound from the prep-state affines plus margin
        # for the intra-match elastic deformation; unbounded -> classic
        kA = warp_ops.shift_bound_K(np.concatenate([A0, A1p[tid1]]), bs, bs)
        if kA is None:
            return None
        K = next((k for k in warp_ops._K_BUCKETS if k >= kA + 2), None)
        if K is None:
            return None
        v0ext = kwargs.get('src_valid0', None) or \
            np.asarray(loader0._img).shape[:2]
        v1ext = kwargs.get('src_valid1', None) or \
            np.asarray(loader1._img).shape[:2]
        b1 = _b1p[tid1] - off1
        env_ok = (_env_interior(origins, bs, K, A0, b0, v0ext)
                  & _env_interior(origins, bs, K, A1p[tid1], b1, v1ext))
        rounds.append({
            'origins': _pad(origins).astype(np.float32),
            'A0': _pad(A0).astype(np.float32),
            'b0': _pad(b0).astype(np.float32),
            'tri_idx': _pad(anchor_idx).astype(np.int32),
            'centers': _pad(centers),
            'anchor_idx': _pad(anchor_idx).astype(np.int32),
            'anchor_idx0': _pad(mesh0.triangles[tid0]).astype(np.int32),
            'valid': valid,
            'env_ok': _pad(env_ok.astype(np.float32)),
            'rlen': np.float64(rlen),
        })
        meta.append((bs, fs, fs, _parse_subpixel(kwargs) if last else False,
                     bool(first), 1e-8 if last else 1e-6, int(K)))
        valid_rounds.append((n, nb, centers, anchor_idx))
        has_last = has_last or last
        first = False
    if not rounds or not has_last:
        return None
    src0 = np.asarray(loader0.preprocess(loader0._img))
    src1 = np.asarray(loader1.preprocess(loader1._img))
    cfg = kwargs.get('in_program_coarse', None)
    coarse = None
    coarse_meta = None
    if cfg is not None:
        pool = int(cfg.get('pool', 4))
        h0p, w0p = src0.shape[0] // pool, src0.shape[1] // pool
        h1p, w1p = src1.shape[0] // pool, src1.shape[1] // pool
        cfy = good_fft_size(h0p + h1p - 1, pow2=True)
        cfx = good_fft_size(w0p + w1p - 1, pow2=True)
        coarse = {
            'v0': np.asarray([int(np.ceil(cfg['valid0'][0] / pool)),
                              int(np.ceil(cfg['valid0'][1] / pool))], np.int32),
            'v1': np.asarray([int(np.ceil(cfg['valid1'][0] / pool)),
                              int(np.ceil(cfg['valid1'][1] / pool))], np.int32),
            'base': np.asarray(cfg['base'], np.float64),
        }
        coarse_meta = (pool, cfy, cfx, float(sigma) / pool)
    return {
        'mesh0': mesh0, 'mesh1': mesh1,
        'src0': src0, 'src1': src1,
        'pos1': mesh1.vertices_w_offset(const.MESH_GEAR_MOVING),
        'verts0_1': mesh1.vertices_w_offset(const.MESH_GEAR_INITIAL) - off1,
        'shape1': mesh1.vertices_w_offset(const.MESH_GEAR_FIXED),
        'tris1': np.asarray(mesh1.triangles, np.int32),
        'mult': np.concatenate([g['multiplier'] for g in groups]),
        'poisson': np.concatenate([g['poisson'] for g in groups]),
        'shape0': mesh0.vertices_w_offset(const.MESH_GEAR_FIXED),
        'tris0': np.asarray(mesh0.triangles, np.int32),
        'mult0': np.concatenate([g['multiplier'] for g in groups0]),
        'poisson0': np.concatenate([g['poisson'] for g in groups0]),
        'pos0': mesh0.vertices_w_offset(const.MESH_GEAR_MOVING),
        'rounds': rounds, 'meta': tuple(meta),
        'env_norm': bool(kwargs.get('envelope_normalize', True)),
        'coarse': coarse, 'coarse_meta': coarse_meta, 'cfg': cfg,
        'valid_rounds': valid_rounds,
        'lam_ratio': abs(float(stiffness_lambda)),
        'sigma': float(sigma), 'conf_thresh': float(conf_thresh),
        'min_num_blocks': min_num_blocks,
        'compute_strain': compute_strain,
    }


def _fused_signature(prep):
    """Static + shape signature for batching compatibility."""
    shapes = tuple((k, prep[k].shape) for k in
                   ('src0', 'src1', 'pos1', 'tris1', 'mult', 'shape0',
                    'tris0', 'mult0'))
    rshapes = tuple(tuple(sorted((k, np.asarray(v).shape)
                                 for k, v in rd.items()))
                    for rd in prep['rounds'])
    return (prep['meta'], prep['coarse_meta'], prep['lam_ratio'],
            prep['sigma'], prep['conf_thresh'], prep['env_norm'],
            shapes, rshapes)


def _fused_finalize(prep, arr):
    """Unpack one pair's packed output, commit mesh1 and build the Match
    (same conventions as the classic path's links)."""
    mesh0, mesh1 = prep['mesh0'], prep['mesh1']
    cfg = prep['cfg']
    conf_thresh = prep['conf_thresh']
    min_num_blocks = prep['min_num_blocks']
    V = prep['pos1'].shape[0]
    if cfg is not None:
        conf_c = float(arr[-2, 0])
        if conf_c < float(cfg.get('conf_thresh', conf_thresh)):
            return None  # meshes untouched; caller takes the classic path
    arr = arr[:-2]
    n_last, nb_last, centers_last, anchor_idx_last = prep['valid_rounds'][-1]
    pos1_new = arr[:V]
    d = arr[V:V + nb_last][:n_last]
    w = arr[V + nb_last:V + 2 * nb_last][:n_last, 1]
    bary12 = arr[V + 2 * nb_last:V + 3 * nb_last][:n_last]
    bary_last = np.concatenate(
        [bary12, 1.0 - bary12.sum(axis=-1, keepdims=True)], axis=-1)
    keep = w > 0
    if keep.sum() < max(min_num_blocks, 1):
        return None
    c = pos1_new.mean(axis=0, keepdims=True)
    mesh1.set_vertices(pos1_new - c, const.MESH_GEAR_MOVING, offset=c)
    xy1_init = np.einsum(
        'nk,nkc->nc', bary_last,
        mesh1.vertices_w_offset(const.MESH_GEAR_INITIAL)[anchor_idx_last])
    xy0_world = centers_last - d
    tid0f = mesh0.tri_finder(xy0_world, gear=const.MESH_GEAR_MOVING,
                             extrapolate=True)
    bary0f = mesh0.cart2bary(xy0_world, tid0f, gear=const.MESH_GEAR_MOVING)
    xy0_init = mesh0.bary2cart(tid0f, bary0f, gear=const.MESH_GEAR_INITIAL)
    if prep['compute_strain']:
        strain = float(np.mean(mesh1.svds_to_deform(
            gear1=const.MESH_GEAR_MOVING)))
        strain = max(strain, 1e-4)
    else:
        strain = config.DEFAULT_AVG_DEFORM
    return common.Match(xy0_init[keep], xy1_init[keep], w[keep], strain)


def _fused_execute_batch(preps, device=None, dtype=torch.float32):
    """Run same-signature preps as ONE batched fused program on the
    device; returns the per-pair packed arrays (host, float64)."""
    p0 = preps[0]
    dev = device_mod.get_device(device)
    stacked = state.stack_preps(preps)
    t = state.to_tensors(stacked, dev, float_dtype=dtype)
    packed = match_loop.fused_rounds_batched(
        t['src0'], t['src1'], t['pos1'], t['verts0_1'], t['shape1'],
        t['tris1'], t['mult'], t['poisson'], t['rounds'], p0['meta'],
        t['shape0'], t['tris0'], t['mult0'], t['poisson0'], t['pos0'],
        lam_ratio=p0['lam_ratio'], sigma=p0['sigma'],
        conf_thresh=p0['conf_thresh'], coarse=t['coarse'],
        coarse_meta=p0['coarse_meta'], env_norm=p0['env_norm'],
        n_valid=tuple(int(np.count_nonzero(rd['valid'] > 0))
                      for rd in stacked['rounds']))
    return packed.cpu().numpy().astype(np.float64)


def _render_blocks(renderer, centers, block_size):
    """Render equal-size blocks centred at world points through the
    renderer in one ``crop_multiple`` pass. Returns (stack (N, h, w)
    float32, kept indices)."""
    h = w = int(round(block_size))
    bboxes = []
    for cx, cy in centers:
        x0 = int(round(cx - w / 2))
        y0 = int(round(cy - h / 2))
        bboxes.append((x0, y0, x0 + w, y0 + h))
    blocks = renderer.crop_multiple(bboxes, return_empty=True)
    out, kept = [], []
    for i, blk in enumerate(blocks):
        if blk is None:
            continue
        out.append(np.asarray(blk, dtype=np.float32))
        kept.append(i)
    if not out:
        return np.zeros((0, h, w), np.float32), np.zeros(0, np.int64)
    return np.stack(out), np.asarray(kept, np.int64)


def iterative_xcorr_matcher_w_mesh(mesh0, mesh1, loader0, loader1, spacings,
                                   device=None, dtype=torch.float32,
                                   **kwargs):
    """Coarse-to-fine mesh-deforming block matcher. mesh0 is locked; mesh1
    deforms. Both meshes' MOVING gears hold the current placement. With
    in-memory ``StreamLoader`` sources the images go to the device once
    and blocks are warped there (the fused schedule when it applies);
    other loaders render blocks through the port's ``MeshRenderer``.
    Returns a ``common.Match`` in INITIAL-gear (source image) coordinates,
    or None."""
    from feabas_tpu_torch.renderer import MeshRenderer
    sigma = kwargs.get('sigma', 2.5)
    conf_mode = kwargs.get('conf_mode', const.FFT_CONF_MIRROR)
    conf_thresh = kwargs.get('conf_thresh', 0.3)
    shrink_factor = kwargs.get('shrink_factor', 1.0)
    pad = kwargs.get('pad', True)
    batch_size = kwargs.get('batch_size', None) or config.fft_batch()
    residue_mode = kwargs.get('residue_mode', 'huber')
    residue_len = kwargs.get('residue_len', 3)
    min_boundary_distance = kwargs.get('min_boundary_distance', 0)
    stiffness_lambda = kwargs.get('stiffness_lambda', -0.35)
    compute_strain = kwargs.get('compute_strain', True)
    min_num_blocks = kwargs.get('min_num_blocks', 2)
    geodesic_mask = kwargs.get('geodesic_mask', False)
    allow_dwell = int(kwargs.get('allow_dwell', 0))
    max_spacing_skip = int(kwargs.get('max_spacing_skip', 0))
    min_block_size_multiplier = float(kwargs.get('min_block_size_multiplier', 4.0))
    link_weight_decay = float(kwargs.get('link_weight_decay', 0.0))
    sp_last = _parse_subpixel(kwargs)
    env_norm = 'peak' if kwargs.get('envelope_normalize', True) else False
    dev = device_mod.get_device(device)

    mesh0.locked = True
    slm = SLM([mesh0, mesh1], dtype=dtype, device=dev)
    spacings = np.asarray(sorted(np.atleast_1d(spacings).astype(np.float64),
                                 reverse=True))
    link = None
    use_device = (kwargs.get('device_render', True)
                  and isinstance(loader0, StreamLoader)
                  and isinstance(loader1, StreamLoader))

    # dominant case -> the whole fine schedule as one device program; the
    # classic loop takes what it does not cover
    if (use_device and kwargs.get('fused_rounds', True)
            and allow_dwell == 0 and max_spacing_skip == 0
            and link_weight_decay <= 0 and residue_mode == 'huber'
            and conf_mode == const.FFT_CONF_MIRROR and pad
            and not geodesic_mask):
        prep = _fused_prep(mesh0, mesh1, loader0, loader1, spacings, **kwargs)
        if kwargs.get('fused_prep_only', False):
            return prep
        if prep is not None:
            match = _fused_finalize(
                prep, _fused_execute_batch([prep], dev, dtype)[0])
            if match is not None:
                return match
    if kwargs.get('fused_prep_only', False):
        return None
    if kwargs.get('in_program_coarse', None) is not None:
        # the placement prior was never refined: let the caller take its
        # host-coarse path instead
        return None

    if use_device:
        src0 = torch.as_tensor(np.asarray(loader0.preprocess(loader0._img)),
                               device=dev)
        src1 = torch.as_tensor(np.asarray(loader1.preprocess(loader1._img)),
                               device=dev)
        src_off0 = np.asarray(loader0._offset, np.float64)
        src_off1 = np.asarray(loader1._offset, np.float64)

    def _vimg(src, key):
        m = torch.zeros(src.shape[:2], dtype=torch.float32, device=dev)
        v = kwargs.get(key, None)
        if v is None:
            m[:] = 1.0
        else:
            m[:int(v[0]), :int(v[1])] = 1.0
        return m

    def _pad_rows(s, nb):
        n_real = s.shape[0]
        if nb == n_real:
            return s
        return torch.cat([s, s[:1].expand((nb - n_real,) + tuple(s.shape[1:]))])

    def _match_round(centers, size_factors, spacing, subpixel):
        """Render or warp both meshes' blocks at the centres and xcorr;
        returns (xy0, xy1, conf, disp_max) among accepted matches or None."""
        out_xy0, out_xy1, out_conf, disp_max = [], [], [], 0.0
        # group by quantized block size so shapes are shared
        sizes = np.maximum(spacing * shrink_factor * size_factors, 16.0)
        qsizes = np.asarray([_quantize_block(s) if use_device
                             else max(int(round(s)), 16) for s in sizes])
        for bs in np.unique(qsizes):
            sel = qsizes == bs
            ctr = centers[sel]
            bs = int(bs)
            bmask0 = bmask1 = None
            if use_device:
                stack0, kept0 = warp_ops.mesh_blocks_device(
                    mesh0, src0, ctr, bs, src_offset=src_off0)
                stack1, kept1 = warp_ops.mesh_blocks_device(
                    mesh1, src1, ctr, bs, src_offset=src_off1)
                if env_norm and subpixel and bs >= 64:
                    # valid-content masks warped through the same affines
                    # for the final round's envelope-normalized peak
                    bmask0, _ = warp_ops.mesh_blocks_device(
                        mesh0, _vimg(src0, 'src_valid0'), ctr, bs,
                        src_offset=src_off0)
                    bmask1, _ = warp_ops.mesh_blocks_device(
                        mesh1, _vimg(src1, 'src_valid1'), ctr, bs,
                        src_offset=src_off1)
            else:
                # nearly-affine blocks skip rasterization (0.1 px tolerance)
                render0 = MeshRenderer.from_mesh(
                    mesh0, image_loader=loader0, geodesic_mask=geodesic_mask,
                    affine_approx_tol=kwargs.get('affine_approx_tol', 0.1),
                    device=dev)
                render1 = MeshRenderer.from_mesh(
                    mesh1, image_loader=loader1, geodesic_mask=geodesic_mask,
                    affine_approx_tol=kwargs.get('affine_approx_tol', 0.1),
                    device=dev)
                stack0, kept0 = _render_blocks(render0, ctr, bs)
                stack1, kept1 = _render_blocks(render1, ctr, bs)
                stack0 = torch.as_tensor(stack0, device=dev)
                stack1 = torch.as_tensor(stack1, device=dev)
            keep = np.intersect1d(kept0, kept1)
            if keep.size == 0:
                continue
            sel0 = torch.as_tensor(np.searchsorted(kept0, keep), device=dev)
            sel1 = torch.as_tensor(np.searchsorted(kept1, keep), device=dev)
            n_real = int(keep.size)
            nb = _pad_pow2(n_real) if use_device else n_real
            s0 = _pad_rows(stack0[sel0], nb)
            s1 = _pad_rows(stack1[sel1], nb)
            if bmask0 is not None:
                bmask0 = _pad_rows(bmask0[sel0], nb)
                bmask1 = _pad_rows(bmask1[sel1], nb)
            parts = []
            for b0 in range(0, nb, batch_size):
                parts.append(xcorr_fft(
                    s0[b0:b0 + batch_size], s1[b0:b0 + batch_size],
                    conf_mode=conf_mode, sigma=sigma, pad=pad,
                    subpixel=subpixel,
                    mask0=None if bmask0 is None else bmask0[b0:b0 + batch_size],
                    mask1=None if bmask1 is None else bmask1[b0:b0 + batch_size],
                    normalize=env_norm if bmask0 is not None else False,
                    return_device=True))
            out = torch.cat(parts, dim=1).cpu().numpy().astype(np.float64)
            dx, dy, conf = out[0, :n_real], out[1, :n_real], out[2, :n_real]
            ok = conf >= conf_thresh
            if not ok.any():
                continue
            # mesh1's world point c shows the content at c - d in mesh0's
            xy1 = ctr[keep][ok]
            out_xy0.append(xy1 - np.stack([dx[ok], dy[ok]], axis=-1))
            out_xy1.append(xy1)
            out_conf.append(conf[ok])
            disp_max = max(disp_max, float(np.hypot(dx[ok], dy[ok]).max()))
        if not out_xy0:
            return None
        return (np.concatenate(out_xy0), np.concatenate(out_xy1),
                np.concatenate(out_conf), disp_max)

    sp_idx = 0
    dwelled = 0
    spacing_enlarged = False
    spacing_override = None
    initialized = False
    max_rounds = len(spacings) * (allow_dwell + 1) + 4
    for _round in range(max_rounds):
        if sp_idx >= len(spacings):
            break
        spacing = spacing_override if spacing_override is not None \
            else float(spacings[sp_idx])
        spacing_override = None
        last_round = (sp_idx == len(spacings) - 1)
        blocks = _block_centers(mesh0, mesh1, spacing, shrink_factor,
                                min_boundary_distance, kwargs)
        if blocks is None:
            return None
        centers, size_factors = blocks
        if centers.shape[0] < min_num_blocks and not last_round:
            sp_idx += 1
            continue
        if centers.shape[0] == 0:
            if not initialized:
                return None
            break
        result = _match_round(centers, size_factors, spacing,
                              subpixel=sp_last if last_round else False)
        if result is None:
            if not initialized:
                return None
            break
        xy0, xy1, conf, disp_max = result
        if link_weight_decay <= 0:
            slm.links = []
        else:
            for l in slm.links:
                l._weight = l._weight * link_weight_decay
        link = slm.add_link_from_coordinates(
            mesh0.uid, mesh1.uid, xy0, xy1, weight=conf,
            gear=(const.MESH_GEAR_MOVING, const.MESH_GEAR_MOVING))
        if not initialized:
            slm.optimize_translation()
        rlen = residue_len if residue_len > 0 else max(spacing * 0.1, 2.0)
        # intermediate rounds only need the mesh roughly right; only the
        # final solve runs tight
        tol_round = 1e-8 if last_round else \
            kwargs.get('opt_tol', None) or min(0.01 / max(1.0, disp_max), 1e-3)
        slm.optimize_elastic(stiffness_lambda=stiffness_lambda,
                             crosslink_lambda=-1.0,
                             residue_mode=residue_mode, residue_len=rlen,
                             tol=tol_round)
        initialized = True
        # schedule the next spacing from the observed displacement
        min_block = min_block_size_multiplier * disp_max
        next_pos = int(np.searchsorted(-spacings, -min_block)) - 1
        if (not spacing_enlarged) and next_pos < 0:
            spacing_enlarged = True
            spacing_override = float(np.ceil(min_block))
            continue
        spacing_enlarged = True
        if next_pos > sp_idx:
            sp_idx = min(next_pos, sp_idx + 1 + max_spacing_skip)
            dwelled = 0
        elif dwelled >= allow_dwell:
            sp_idx += 1
            dwelled = 0
        else:
            dwelled += 1
    if link is None or link.num_matches == 0:
        return None
    w = link.weight()
    keep = w > 0
    if not keep.any():
        return None
    xy0 = link.xy0(gear=const.MESH_GEAR_INITIAL)[keep]
    xy1 = link.xy1(gear=const.MESH_GEAR_INITIAL)[keep]
    if compute_strain:
        strain = float(np.mean(mesh1.svds_to_deform(
            gear1=const.MESH_GEAR_MOVING)))
        strain = max(strain, 1e-4)
    else:
        strain = config.DEFAULT_AVG_DEFORM
    return common.Match(xy0, xy1, w[keep], strain)


_FINE_KWARGS = ('residue_mode', 'residue_len', 'pad', 'batch_size',
                'shrink_factor', 'min_boundary_distance', 'stiffness_lambda',
                'conf_mode', 'distributor', 'geodesic_mask', 'allow_dwell',
                'max_spacing_skip', 'min_block_size_multiplier',
                'link_weight_decay', 'fused_rounds', 'envelope_normalize',
                'subpixel_upsample', 'device', 'dtype')


def stitching_matcher(img0, img1, **kwargs):
    """Match two overlapping tiles. A stage prior (``stage_prior``, img1's
    origin in img0's frame) with an overlap >= 256 px takes the fused
    path with the in-program coarse seed; otherwise the host global
    translation seeds the fine stage. Returns a ``common.Match`` in full-
    resolution tile coordinates, a fused prep dict with
    ``fused_prep_only``, or None."""
    import cv2
    sigma = kwargs.get('sigma', 2.5)
    conf_thresh = kwargs.get('conf_thresh', 0.3)
    coarse_downsample = kwargs.get('coarse_downsample', 1.0)
    fine_downsample = kwargs.get('fine_downsample', 1.0)
    spacings = kwargs.get('spacings', None)
    mask0 = kwargs.get('mask0', None)
    mask1 = kwargs.get('mask1', None)
    img0 = np.asarray(img0)
    img1 = np.asarray(img1)

    def _scaled(img, scale):
        if scale == 1.0:
            return np.asarray(img)
        return cv2.resize(np.asarray(img), None, fx=scale, fy=scale,
                          interpolation=cv2.INTER_AREA)

    fs = fine_downsample

    def _fine(t, in_program_coarse_pool=None):
        f0 = _scaled(img0, fs)
        f1 = _scaled(img1, fs)
        mesh_size = max(np.hypot(*f0.shape) / 8, 50)
        mesh0 = Mesh.from_bbox((0, 0, f0.shape[1], f0.shape[0]),
                               cartesian=True, mesh_size=mesh_size, uid=0,
                               locked=True)
        mesh1 = Mesh.from_bbox((0, 0, f1.shape[1], f1.shape[0]),
                               cartesian=True, mesh_size=mesh_size, uid=1,
                               soft_factor=1.0 / config.MATCH_SOFTFACTOR_DOMINANCE)
        mesh1.set_translation(t)
        ovl, valid = common.intersect_bbox(
            (0, 0, f0.shape[1], f0.shape[0]),
            (t[0], t[1], t[0] + f1.shape[1], t[1] + f1.shape[0]))
        if not valid:
            return None
        sp = spacings
        if sp is None:
            short = min(ovl[2] - ovl[0], ovl[3] - ovl[1])
            s0 = float(np.clip(short / 3.0, 25.0, 200.0))
            sp = [s0] if s0 <= 60 else [s0, max(s0 / 2, 50.0)]
            sp = np.asarray(sp) / fs
        # only the overlap band (+ block-reach margin) goes to the device
        band_margin = 2.0 * float(np.max(sp))

        def _band(img, bbox):
            h, w = img.shape[:2]
            x0 = int(np.clip(np.floor(bbox[0] - band_margin), 0, w))
            y0 = int(np.clip(np.floor(bbox[1] - band_margin), 0, h))
            x1 = int(np.clip(np.ceil(bbox[2] + band_margin), 0, w))
            y1 = int(np.clip(np.ceil(bbox[3] + band_margin), 0, h))
            band = img[y0:y1, x0:x1]
            # band shapes bucket to 64-multiples (zero fill = the warp's
            # out-of-range fill), so same-size overlaps batch together
            hb, wb = band.shape[:2]
            hp, wp = -(-hb // 64) * 64, -(-wb // 64) * 64
            if (hp, wp) != (hb, wb):
                out = np.zeros((hp, wp), band.dtype)
                out[:hb, :wb] = band
                band = out
            return band, (x0, y0), (hb, wb)

        f0b, off0, v0 = _band(f0, ovl)
        ovl1 = (ovl[0] - t[0], ovl[1] - t[1], ovl[2] - t[0], ovl[3] - t[1])
        f1b, off1, v1 = _band(f1, ovl1)
        extra = {'src_valid0': v0, 'src_valid1': v1}
        if kwargs.get('fused_prep_only', False):
            extra['fused_prep_only'] = True
        if in_program_coarse_pool:
            c_arr0 = np.array([f0b.shape[1], f0b.shape[0]]) / 2.0
            c_arr1 = np.array([f1b.shape[1], f1b.shape[0]]) / 2.0
            base = (c_arr0 - c_arr1 + np.asarray(off0, np.float64)
                    - np.asarray(off1, np.float64) - np.asarray(t, np.float64))
            extra['in_program_coarse'] = {
                'valid0': v0, 'valid1': v1, 'base': base,
                'pool': int(in_program_coarse_pool),
                'conf_thresh': conf_thresh,
            }
        return iterative_xcorr_matcher_w_mesh(
            mesh0, mesh1, StreamLoader(f0b, offset=off0),
            StreamLoader(f1b, offset=off1),
            np.asarray(sp, np.float64) * fs,
            sigma=sigma * fs, conf_thresh=conf_thresh, **extra,
            **{k: v for k, v in kwargs.items() if k in _FINE_KWARGS})

    def _dims(img):
        return np.array([int(round(img.shape[1] * fs)),
                         int(round(img.shape[0] * fs))], np.float64)

    stage_prior = kwargs.get('stage_prior', None)
    if ((kwargs.get('stage_aligned', False) or stage_prior is not None)
            and mask0 is None and mask1 is None):
        if stage_prior is not None:
            t0 = np.asarray(stage_prior, np.float64) * fs
        else:
            t0 = _dims(img0) / 2 - _dims(img1) / 2
        d0, d1 = _dims(img0), _dims(img1)
        ovl0, valid0 = common.intersect_bbox(
            (0, 0, d0[0], d0[1]), (t0[0], t0[1], t0[0] + d1[0],
                                   t0[1] + d1[1]))
        # the frozen lattice tolerates a few px of prior error only when
        # the overlap dwarfs the block size
        if valid0 and min(ovl0[2] - ovl0[0], ovl0[3] - ovl0[1]) >= 256:
            pool = max(int(round(1.0 / coarse_downsample)), 1)
            match = _fine(t0, in_program_coarse_pool=pool)
            if isinstance(match, dict):   # fused_prep_only mode
                match['fs'] = fs
                return match
            if match is not None:
                return common.Match(match.xy0 / fs, match.xy1 / fs,
                                    match.weight, match.strain)
        if kwargs.get('fused_prep_only', False):
            return None

    c0 = _scaled(img0, coarse_downsample)
    c1 = _scaled(img1, coarse_downsample)
    dx, dy, conf = global_translation_matcher(
        c0, c1, device=kwargs.get('device'),
        sigma=sigma * coarse_downsample, conf_thresh=conf_thresh,
        mask0=mask0, mask1=mask1)
    if conf < conf_thresh:
        return None
    dx /= coarse_downsample
    dy /= coarse_downsample
    t = _dims(img0) / 2 - _dims(img1) / 2 - np.array([dx, dy]) * fs
    match = _fine(t)
    if match is None:
        return None
    return common.Match(match.xy0 / fs, match.xy1 / fs, match.weight,
                        match.strain)


def match_pairs_batched(jobs, max_batch=MAX_BATCH, device=None,
                        dtype=torch.float32):
    """Match many tile pairs; same-shape pairs with a stage prior run as
    one batched fused program per ``max_batch`` pairs.

    ``jobs``: list of (img0, img1, kwargs) as ``stitching_matcher`` takes.
    Returns a list of Match|None aligned with ``jobs``. Pairs the fused
    path declines (no prior, small overlap, low coarse confidence, too
    few blocks) go through ``stitching_matcher`` one by one."""
    dev = device_mod.get_device(device)
    results = [None] * len(jobs)
    preps = []
    serial = []
    for idx, (img0, img1, kw) in enumerate(jobs):
        kw = {**kw, 'device': dev, 'dtype': dtype}
        prep = None
        if kw.get('stage_prior') is not None or kw.get('stage_aligned'):
            prep = stitching_matcher(img0, img1, fused_prep_only=True, **kw)
        if isinstance(prep, dict):
            preps.append((idx, prep))
        else:
            serial.append(idx)
    groups = {}
    for idx, prep in preps:
        groups.setdefault(_fused_signature(prep), []).append((idx, prep))
    for members in groups.values():
        for s in range(0, len(members), max_batch):
            chunk = members[s:s + max_batch]
            arrs = _fused_execute_batch([p for _, p in chunk], dev, dtype)
            for (idx, prep), arr in zip(chunk, arrs):
                m = _fused_finalize(prep, arr)
                if m is None:
                    serial.append(idx)
                    continue
                fs = prep.get('fs', 1.0)
                results[idx] = common.Match(m.xy0 / fs, m.xy1 / fs,
                                            m.weight, m.strain)
    for idx in serial:
        img0, img1, kw = jobs[idx]
        results[idx] = stitching_matcher(
            img0, img1, **{**kw, 'device': dev, 'dtype': dtype})
    return results


def section_matcher(mesh0, mesh1, loader0, loader1, **kwargs):
    """Match two roughly aligned sections through their meshes. Sections
    cut into disconnected pieces split into connected components, and each
    overlapping component pair is matched on its own, so one piece's drift
    cannot spoil another's relaxation."""
    spacings = kwargs.pop('spacings', [400, 100])
    split = kwargs.pop('split_disconnected', True)
    if split and (mesh0.num_connected > 1 or mesh1.num_connected > 1):
        parts0 = mesh0.divide_disconnected_mesh() \
            if mesh0.num_connected > 1 else [mesh0]
        parts1 = mesh1.divide_disconnected_mesh() \
            if mesh1.num_connected > 1 else [mesh1]
        xy0s, xy1s, ws, strains, wsum = [], [], [], [], 0.0
        for p0 in parts0:
            b0 = p0.bbox(gear=const.MESH_GEAR_MOVING)
            for p1 in parts1:
                _, valid = common.intersect_bbox(
                    b0, p1.bbox(gear=const.MESH_GEAR_MOVING))
                if not valid:
                    continue
                m = iterative_xcorr_matcher_w_mesh(
                    p0.copy(), p1.copy(), loader0, loader1, spacings,
                    **kwargs)
                if m is None or m.xy0.shape[0] == 0:
                    continue
                xy0s.append(m.xy0)
                xy1s.append(m.xy1)
                ws.append(m.weight)
                strains.append(m.strain * float(np.sum(m.weight)))
                wsum += float(np.sum(m.weight))
        if not xy0s:
            return None
        strain = (sum(strains) / wsum) if wsum > 0 else config.DEFAULT_AVG_DEFORM
        return common.Match(np.concatenate(xy0s), np.concatenate(xy1s),
                            np.concatenate(ws), strain)
    return iterative_xcorr_matcher_w_mesh(mesh0, mesh1, loader0, loader1,
                                          spacings, **kwargs)
