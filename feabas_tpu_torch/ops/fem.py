"""Matrix-free finite-element operators and PCG (counterpart of
``feabas_tpu/ops/fem.py``: the ENG, SVK and NHK elements and the stiffness
curve, the scatter, incidence-gather and lattice-stencil matvecs,
crosslinks, the general CG operator and CG).

    A x = lambda_s K(x) + C^T W C x

K gathers per-element displacement vectors, applies the (NT, 6, 6)
element blocks and scatter-adds back; the crosslink term does the same
over (vertex index, barycentric, weight) link arrays. Vertex arrays are
(NV, 2). ``cg_solve`` also takes a leading batch axis: independent
systems stacked as (P, NV, 2), each with its own stopping state.
"""

import ctypes

import numpy as np
import torch

from feabas_tpu_torch import build, trace
from feabas_tpu_torch import device as device_mod

# Voigt selector: [du/dx, dv/dy, du/dy + dv/dx] from the flat gradient
_VOIGT = np.array([[1, 0, 0, 0],
                   [0, 0, 0, 1],
                   [0, 1, 1, 0]], dtype=np.float32)


def shape_matrices(tripts):
    """Per-element gradient operator from (NT, 3, 2) resting vertices.
    Returns B (NT, 4, 6) with B @ uv = [du/dx, du/dy, dv/dx, dv/dy] and
    area2 (NT,) = twice the area."""
    e = torch.roll(tripts, -1, dims=1) - torch.roll(tripts, 1, dims=1)
    area2 = torch.abs(e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0])
    gx = e[:, :, 1] / area2[:, None]
    gy = -e[:, :, 0] / area2[:, None]
    nt = tripts.shape[0]
    B = torch.zeros((nt, 4, 6), dtype=tripts.dtype, device=tripts.device)
    B[:, 0, 0::2] = gx
    B[:, 1, 0::2] = gy
    B[:, 2, 1::2] = gx
    B[:, 3, 1::2] = gy
    return B, area2


def _dmat(nu):
    nt = nu.shape[0]
    D = torch.zeros((nt, 3, 3), dtype=nu.dtype, device=nu.device)
    D[:, 0, 0] = 1.0
    D[:, 1, 1] = 1.0
    D[:, 0, 1] = nu
    D[:, 1, 0] = nu
    D[:, 2, 2] = (1.0 - nu) / 2.0
    return D


def eng_element_stiffness(B, area2, multiplier, poisson):
    """Linear engineering-strain element stiffness (NT, 6, 6)."""
    V = torch.as_tensor(_VOIGT, dtype=B.dtype, device=B.device)
    Bn = torch.einsum('ij,njk->nik', V, B)
    D = _dmat(poisson.to(B.dtype))
    K = torch.einsum('nji,njk,nkl->nil', Bn, D, Bn)
    return K * (area2 * multiplier)[:, None, None]


def gather_uv(x, tris):
    """x (NV, 2) -> per-element (NT, 6) [u1, v1, u2, v2, u3, v3]."""
    return x[tris].reshape(tris.shape[0], 6)


def scatter_uv(y_e, tris, nv):
    """(NT, 6) element contributions -> (NV, 2) by scatter-add."""
    out = torch.zeros((nv, 2), dtype=y_e.dtype, device=y_e.device)
    return out.index_add_(0, tris.reshape(-1), y_e.reshape(-1, 2))


def _sorted_rows(index, n):
    """(order, ptr) of ``index`` (any shape, values in [0, n]; n marks an
    entry no row holds): the stable ascending order of its flat entries
    and each row's start in it, ptr (n+1,). Device ops only: no host copy,
    no sync."""
    index = index.reshape(-1).long()
    order = torch.argsort(index, stable=True)
    ptr = torch.searchsorted(index[order],
                             torch.arange(n + 1, device=index.device))
    return order, ptr


def fixed_sum(index, n):
    """vals -> ``zeros(n, ...).index_add_(0, index, vals)`` in a fixed
    order: each row's entries in ascending position, one segment sum, no
    atomics, so a CUDA tensor gives the same bits call after call (CUDA's
    ``index_add_`` does not). The order is sorted once, here, for every
    call of the returned function."""
    order, ptr = _sorted_rows(index, n)
    return lambda vals: torch.segment_reduce(vals[order], 'sum', offsets=ptr,
                                             axis=0)


def stiffness_matvec(x, Ke, tris):
    """K @ x for (NV, 2) x."""
    y = torch.einsum('nij,nj->ni', Ke, gather_uv(x, tris))
    return scatter_uv(y, tris, x.shape[0])


def stiffness_diag(Ke, tris, nv):
    return scatter_uv(torch.diagonal(Ke, dim1=1, dim2=2), tris, nv)


def stiffness_force(x, Ke, tris):
    """Internal force vector of linear elements (= K x)."""
    return stiffness_matvec(x, Ke, tris)


# ---------------------------- nonlinear elements ---------------------------- #

def deformation_gradient(B, uv):
    """flat F = B @ uv + flat(I): (NT, 4) = [F11, F12, F21, F22]."""
    F = torch.einsum('nij,nj->ni', B, uv)
    return F + torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=B.dtype,
                            device=B.device)


def area_stretch(B, uv):
    """det F per element: (NT,)."""
    F = deformation_gradient(B, uv)
    return F[:, 0] * F[:, 3] - F[:, 1] * F[:, 2]


def eng_element_stress(Ke, uv):
    return torch.einsum('nij,nj->ni', Ke, uv)


def svk_element(B, area2, uv, multiplier, poisson):
    """St. Venant-Kirchhoff tangent stiffness and internal force:
    (Ke (NT, 6, 6), Pe (NT, 6)). At uv = 0 the tangent is the linear
    engineering stiffness."""
    F = deformation_gradient(B, uv)
    F11, F12, F21, F22 = F.unbind(-1)
    # Green strain, Voigt [E11, E22, 2 E12]
    Ev = torch.stack([0.5 * (F11 * F11 + F21 * F21 - 1.0),
                      0.5 * (F12 * F12 + F22 * F22 - 1.0),
                      F11 * F12 + F21 * F22], dim=-1)
    D = _dmat(poisson.to(B.dtype))
    S = torch.einsum('nij,nj->ni', D, Ev)                # [S11, S22, S12]
    # BN: dE_voigt = BN @ duv, rows from dE = sym(F^T dF)
    zero = torch.zeros_like(F11)
    AF = torch.stack([torch.stack([F11, zero, F21, zero], -1),
                      torch.stack([zero, F12, zero, F22], -1),
                      torch.stack([F12, F11, F22, F21], -1)], dim=1)
    BN = torch.einsum('nij,njk->nik', AF, B)             # (NT, 3, 6)
    # geometric stiffness: block-diag [[S11, S12], [S12, S22]] per component
    S11, S22, S12 = S.unbind(-1)
    Sg = torch.stack([torch.stack([S11, S12, zero, zero], -1),
                      torch.stack([S12, S22, zero, zero], -1),
                      torch.stack([zero, zero, S11, S12], -1),
                      torch.stack([zero, zero, S12, S22], -1)], dim=1)
    Kmat = torch.einsum('nji,njk,nkl->nil', BN, D, BN)
    Kgeo = torch.einsum('nji,njk,nkl->nil', B, Sg, B)
    scale = area2 * multiplier
    Ke = (Kmat + Kgeo) * scale[:, None, None]
    Pe = torch.einsum('nji,nj->ni', BN, S) * scale[:, None]
    return Ke, Pe


# flat(F^-T) = _ADJT @ flat(F) / det(F)
_ADJT = np.array([[0, 0, 0, 1],
                  [0, 0, -1, 0],
                  [0, -1, 0, 0],
                  [1, 0, 0, 0]], dtype=np.float32)


def nhk_element(B, area2, uv, multiplier):
    """Neo-Hookean (mu only, psi = mu/2 (I1 - 2 - 2 ln J)) tangent
    stiffness and internal force: (Ke (NT, 6, 6), Pe (NT, 6))."""
    F = deformation_gradient(B, uv)
    J = F[:, 0] * F[:, 3] - F[:, 1] * F[:, 2]
    U = torch.as_tensor(_ADJT, dtype=B.dtype, device=B.device)
    Fu = torch.einsum('ij,nj->ni', U, F)     # flat adj(F)^T = J flat(F^-T)
    Pf = F - Fu / J[:, None]                 # mu (F - F^-T)
    I4 = torch.eye(4, dtype=B.dtype, device=B.device)
    dPdF = (I4[None] - U[None] / J[:, None, None]
            + Fu[:, :, None] * Fu[:, None, :] / (J ** 2)[:, None, None])
    scale = 0.5 * area2 * multiplier
    Ke = torch.einsum('nji,njk,nkl->nil', B, dPdF, B) * scale[:, None, None]
    Pe = torch.einsum('nji,nj->ni', B, Pf) * scale[:, None]
    return Ke, Pe


def interp(x, xp, fp, left=None, right=None):
    """Piecewise-linear interpolation by ``jnp.interp``'s rule: the segment
    is the last knot <= x (a value on a knot takes that knot's value), an
    interval no wider than the spacing of eps takes its left value, and
    values left of ``xp[0]`` / right of ``xp[-1]`` take ``left`` /
    ``right`` (default ``fp[0]`` / ``fp[-1]``)."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = np.finfo(np.float64 if xp.dtype == torch.float64 else np.float32).eps
    flat = dx.abs() <= float(np.spacing(eps))
    f = torch.where(flat, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(flat, torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0] if left is None else left, f)
    return torch.where(x > xp[-1], fp[-1] if right is None else right, f)


def stiffness_curve_multiplier(J, knots_x, knots_y):
    """Per-element nonlinear stiffness factor from a sampled curve."""
    return interp(J, knots_x, knots_y, left=knots_y[0], right=knots_y[-1])


# -------------------------- incidence gather -------------------------- #

def build_incidence(tris, nv, max_degree=None):
    """Vertex -> element-corner incidence table (host, once per topology):
    ``inc[v, d]`` indexes the flattened (NT*3) per-corner contribution
    array, ``mask[v, d]`` zeroes padding. The FEM transpose then gathers
    instead of scatter-adding. Returns (inc int32 (NV, D), mask float32
    (NV, D))."""
    tris = np.asarray(tris)
    flat_v = tris.ravel()                    # corner k of element t -> vertex
    order = np.argsort(flat_v, kind='stable')
    sorted_v = flat_v[order]
    counts = np.bincount(flat_v, minlength=nv)
    D = int(max_degree or (counts.max() if counts.size else 1))
    inc = np.zeros((nv, D), np.int32)
    mask = np.zeros((nv, D), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos_in_group = np.arange(flat_v.size) - starts[sorted_v]
    keep = pos_in_group < D
    inc[sorted_v[keep], pos_in_group[keep]] = order[keep].astype(np.int32)
    mask[sorted_v[keep], pos_in_group[keep]] = 1.0
    return inc, mask


def gather_scatter_uv(y_e, inc, mask):
    """(NT, 6) element contributions -> (NV, 2) by incidence gather."""
    g = y_e.reshape(-1, 2)[inc]              # (NV, D, 2)
    return (g * mask[..., None]).sum(dim=1)


def stiffness_matvec_gather(x, Ke, tris, inc, mask):
    """K @ x with the incidence gather in place of the scatter-add."""
    y = torch.einsum('nij,nj->ni', Ke, gather_uv(x, tris))
    return gather_scatter_uv(y, inc, mask)


# --------------------------- lattice stencil --------------------------- #
# Lattice meshes (cartesian grids with alternating diagonals, equilateral
# row-staggered grids) admit a 9-point stencil on the vertex lattice: per
# vertex one 2x2 block per {-1,0,1}^2 neighbour offset, so the matvec is 9
# shifted multiply-adds with no gather or scatter. The stencil functions
# below take any leading batch axes (a stack of sections).

def lattice_embedding(verts, tris, min_occupancy=0.5):
    """Integer lattice embedding of a mesh (host, once per topology).

    Returns (cell_of (NV,) int64 row-major cell ids, (ny, nx)) such that
    every triangle's vertex-pair offsets lie in {-1,0,1}^2 and no two
    vertices share a cell, or None when the mesh is not a lattice.
    Validation is combinatorial, so a stencil built on a returned
    embedding is exact. Tries a linear two-vector basis, a staggered row
    layout, row-rank columns and a BFS over the edge graph.
    """
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris)
    nv = verts.shape[0]
    if nv < 16 or tris.shape[0] < 8:
        return None

    def validate(pos):
        pos = pos - pos.min(axis=0)
        ny = int(pos[:, 1].max()) + 1
        nx = int(pos[:, 0].max()) + 1
        if ny < 2 or nx < 2 or nv < min_occupancy * ny * nx:
            return None
        off = pos[tris] - pos[tris[:, :1]]
        d01 = pos[tris[:, 1]] - pos[tris[:, 0]]
        d12 = pos[tris[:, 2]] - pos[tris[:, 1]]
        if max(np.abs(d01).max(), np.abs(d12).max(),
               np.abs(off).max()) > 1:
            return None
        cells = pos[:, 1] * nx + pos[:, 0]
        if np.unique(cells).size != nv:
            return None
        return cells.astype(np.int64), (ny, nx)

    # edge vectors, sign-normalized, clustered at 1/4-px resolution
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    d = verts[e[:, 1]] - verts[e[:, 0]]
    flip = (d[:, 1] < 0) | ((d[:, 1] == 0) & (d[:, 0] < 0))
    d = np.where(flip[:, None], -d, d)
    key = np.round(d * 4).astype(np.int64)
    uniq, counts = np.unique(key, axis=0, return_counts=True)
    cand = uniq[np.argsort(-counts)][:6] / 4.0
    ref = verts[0]

    def bases():
        for a in range(len(cand)):
            for b in range(a + 1, len(cand)):
                E = np.stack([cand[a], cand[b]], axis=1)
                scale = np.linalg.norm(cand[a]) * np.linalg.norm(cand[b])
                if abs(np.linalg.det(E)) >= 0.1 * max(scale, 1e-12):
                    yield E

    # 1) linear basis: vertices at ref + E @ (i, j)
    for E in bases():
        q = np.linalg.solve(E, (verts - ref).T).T
        p = np.round(q)
        if np.abs(q - p).max() > 0.25:
            continue
        out = validate(p.astype(np.int64))
        if out is not None:
            return out
    # 2) staggered rows: pitch a along x, row height h, odd rows +a/2
    horiz = cand[(np.abs(cand[:, 1]) < 0.25) & (np.abs(cand[:, 0]) > 0.25)]
    diag = cand[np.abs(cand[:, 1]) > 0.25]
    if len(horiz) and len(diag):
        a = abs(horiz[0, 0])
        h = abs(diag[0, 1])
        row_f = (verts[:, 1] - ref[1]) / h
        row = np.round(row_f)
        if np.abs(row_f - row).max() <= 0.25:
            for parity in (0, 1):
                col_f = (verts[:, 0] - ref[0]
                         - ((row.astype(np.int64) + parity) % 2) * a / 2) / a
                col = np.round(col_f)
                if np.abs(col_f - col).max() > 0.25:
                    continue
                out = validate(np.stack([col, row], -1).astype(np.int64))
                if out is not None:
                    return out
    # 2b) row-rank: y-rows, columns by within-row x-rank (rows left-aligned)
    ys = np.sort(np.unique(verts[:, 1]))
    gaps = np.diff(ys)
    if gaps.size:
        h_est = np.median(gaps[gaps > gaps.max() * 0.5]) \
            if (gaps > gaps.max() * 0.5).any() else gaps.max()
        row_edges = np.nonzero(gaps > 0.4 * h_est)[0]
        row_of_y = np.zeros(ys.size, np.int64)
        row_of_y[row_edges + 1] = 1
        row_of_y = np.cumsum(row_of_y)
        row = row_of_y[np.searchsorted(ys, verts[:, 1])]
        order = np.lexsort((verts[:, 0], row))
        col = np.zeros(nv, np.int64)
        r_sorted = row[order]
        starts = np.searchsorted(r_sorted, np.arange(r_sorted.max() + 2))
        col[order] = np.arange(nv) - starts[r_sorted]
        out = validate(np.stack([col, row], -1))
        if out is not None:
            return out
    # 3) BFS propagation of rounded per-edge basis offsets (lattices whose
    # boundary rows conform to the ROI ring)
    for E in bases():
        out = _bfs_lattice(verts, tris, E, validate)
        if out is not None:
            return out
    return None


def _bfs_lattice(verts, tris, E, validate):
    """Integer lattice coords by propagating rounded per-edge basis offsets
    over a BFS spanning tree of the triangle edge graph; ``validate``
    decides."""
    import collections
    nv = verts.shape[0]
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = np.concatenate([e, e[:, ::-1]])
    d = verts[e[:, 1]] - verts[e[:, 0]]
    q = np.linalg.solve(E, d.T).T
    off = np.round(q).astype(np.int64)
    if np.abs(q - off).max() > 0.45 or np.abs(off).max() > 1:
        return None
    order = np.argsort(e[:, 0], kind='stable')
    starts = np.searchsorted(e[order, 0], np.arange(nv + 1))
    pos = np.zeros((nv, 2), np.int64)
    seen = np.zeros(nv, bool)
    seen[0] = True
    dq = collections.deque([0])
    n_seen = 1
    while dq:
        u = dq.popleft()
        for k in order[starts[u]:starts[u + 1]]:
            v = e[k, 1]
            if not seen[v]:
                seen[v] = True
                n_seen += 1
                pos[v] = pos[u] + off[k]
                dq.append(v)
    if n_seen != nv:
        return None                      # disconnected mesh
    return validate(pos)


def stencil_targets(tris, nx, nv):
    """(T, 3, 3) flat assembly targets ``plane * nv + cell`` of the 9-plane
    stencil from lattice-packed (row-major cell id) triangles; numpy or
    torch."""
    cx = tris % nx
    cy = tris // nx
    ox = cx[:, None, :] - cx[:, :, None]
    oy = cy[:, None, :] - cy[:, :, None]
    plane = (oy + 1) * 3 + (ox + 1)
    return plane * nv + tris[:, :, None]


def build_stencil_assembly(tris, nx, nv):
    """Host gather table of the stencil assembly (once per topology): for
    each (plane, vertex) destination, the rows of the flattened (T*9 + 1)-row
    element-block array that contribute (row t*9 + i*3 + j = element t's
    (i, j) 2x2 block; pad entries point at the trailing zero row).
    Returns (9*nv, D) int32."""
    tris = np.asarray(tris)
    T = tris.shape[0]
    tgt = np.asarray(stencil_targets(tris, nx, nv)).reshape(-1)
    order = np.argsort(tgt, kind='stable')
    st = tgt[order]
    counts = np.bincount(st, minlength=9 * nv)
    D = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rows = np.full((9 * nv, D), T * 9, np.int32)
    rows[st, np.arange(T * 9) - starts[st]] = order
    return rows


def stencil_assemble_gather(Ke, rows):
    """(..., T, 6, 6) element stiffness -> (..., 9*nv, 2, 2) coefficient
    planes by the ``build_stencil_assembly`` gather (plane k couples each
    vertex to its neighbour at offset (k%3-1, k//3-1))."""
    lead = Ke.shape[:-3]
    T = Ke.shape[-3]
    Kb = Ke.reshape(*lead, T, 3, 2, 3, 2).transpose(-3, -2)
    Kb = Kb.reshape(*lead, T * 9, 2, 2)
    Kb = torch.cat([Kb, Kb.new_zeros(*lead, 1, 2, 2)], dim=-3)
    return Kb[..., rows.long(), :, :].sum(dim=-3)


def stiffness_matvec_stencil(x, C, ny, nx):
    """K @ x as 9 shifted multiply-adds on the (ny, nx) vertex lattice;
    x (..., nv, 2), C (..., 9*nv, 2, 2). Off-grid neighbours carry zero
    coefficients, so zero padding is exact."""
    lead = x.shape[:-2]
    xp = torch.nn.functional.pad(x.reshape(*lead, ny, nx, 2),
                                 (0, 0, 1, 1, 1, 1))
    Cg = C.reshape(*lead, 9, ny, nx, 2, 2)
    out = torch.zeros(*lead, ny, nx, 2, dtype=x.dtype, device=x.device)
    for k in range(9):
        oy, ox = k // 3 - 1, k % 3 - 1
        xs = xp[..., 1 + oy:1 + oy + ny, 1 + ox:1 + ox + nx, :]
        out = out + (Cg[..., k, :, :, :, :] * xs[..., None, :]).sum(-1)
    return out.reshape(*lead, ny * nx, 2)


def stencil_diag(C, nv):
    """Jacobi diagonal (..., nv, 2) from the stencil's self-plane."""
    C4 = C.reshape(*C.shape[:-3], 9, nv, 2, 2)[..., 4, :, :, :]
    return torch.stack([C4[..., 0, 0], C4[..., 1, 1]], dim=-1)


# ------------------------------ crosslinks ------------------------------ #
# A link couples a barycentric point on one mesh to one on another (global
# vertex indexing): r_l = sum_i b1_i x[i1_i] - sum_i b0_i x[i0_i] + offset_l.

def link_eval(x, idx, bary):
    """Barycentric sample of (NV, 2) x at links: (L, 2)."""
    return torch.einsum('lk,lkc->lc', bary, x[idx])


def link_residual(x, idx0, bary0, idx1, bary1, offset):
    return link_eval(x, idx1, bary1) - link_eval(x, idx0, bary0) + offset


def _link_scatter(out, idx, bary, r, sign):
    vals = (sign * bary)[:, :, None] * r[:, None, :]
    return out.index_add_(0, idx.reshape(-1), vals.reshape(-1, 2))


def crosslink_matvec(x, idx0, bary0, idx1, bary1, weight):
    """(C^T W C) x with W = diag(weight^2) over both xy components."""
    r = link_eval(x, idx1, bary1) - link_eval(x, idx0, bary0)
    r = r * (weight ** 2)[:, None]
    out = torch.zeros_like(x)
    _link_scatter(out, idx1, bary1, r, 1.0)
    return _link_scatter(out, idx0, bary0, r, -1.0)


def crosslink_rhs(x_current, idx0, bary0, idx1, bary1, weight, offset):
    """-C^T W r(x_current)."""
    r = link_residual(x_current, idx0, bary0, idx1, bary1, offset)
    r = r * (weight ** 2)[:, None]
    out = torch.zeros_like(x_current)
    _link_scatter(out, idx1, bary1, r, -1.0)
    return _link_scatter(out, idx0, bary0, r, 1.0)


def crosslink_diag(nv, idx0, bary0, idx1, bary1, weight, dtype=torch.float32):
    """Diagonal of C^T W C (exact for real links; Jacobi otherwise)."""
    dev = weight.device
    w2 = (weight.to(dtype) ** 2)[:, None]
    d = torch.zeros((nv, 2), dtype=dtype, device=dev)
    for idx, bary in ((idx1, bary1), (idx0, bary0)):
        v = (bary.to(dtype) ** 2 * w2)[:, :, None].expand(-1, -1, 2)
        d.index_add_(0, idx.reshape(-1), v.reshape(-1, 2))
    return d


# The solves' link sums: ``push`` sums per link-point rows of side 0 and of
# side 1, (L, 3, C) each, onto their vertices (NV, C) with no atomics; the
# scatter forms above are the plain versions the tests pin against JAX.

def link_sum(idx0, idx1, nv):
    """``push`` through one fixed-order sum (``fixed_sum``) over the link
    points, side 0's then side 1's."""
    by_point = fixed_sum(torch.cat([idx0, idx1]), nv)
    return lambda c0, c1: by_point(torch.cat([c0, c1])
                                   .reshape(-1, c0.shape[-1]))


def link_transpose(push, bary0, bary1, r):
    """C^T r (NV, 2) for per-link rows r (L, 2): -bary0 on side 0, +bary1
    on side 1."""
    return push(-bary0[:, :, None] * r[:, None, :],
                bary1[:, :, None] * r[:, None, :])


def link_diag(push, bary0, bary1, weight):
    """Diagonal of C^T W C (NV, 2) (exact for real links; Jacobi
    otherwise)."""
    w2 = (weight ** 2)[:, None, None]
    return push((bary0[:, :, None] ** 2 * w2).expand(-1, -1, 2),
                (bary1[:, :, None] ** 2 * w2).expand(-1, -1, 2))


# ------------------------- the general CG operator ------------------------- #
# y = free * (lam_s K x + lam_c C^T W^2 C x) in one launch of
# csrc/fem_operator.cu, over any
# number of element groups concatenated into one (NT, 6, 6) Ke and one
# (NT, 3) tris, and one flat list of links.

def operator_tables(tris, nv, idx0, bary0, idx1, bary1, keep=None,
                    n_kept=None):
    """The tables of ``bind_elastic_operator`` (once a solve), built from
    tensors on their own device (stable sorts, a ``searchsorted``: no host
    copy, no sync): the element corners and link points as given and the
    kernel's two CSR tables. ``inc_ptr`` / ``inc_ent`` list each vertex's
    (element, corner) pairs as ``t * 3 + c``; ``lnk_ptr`` / ``lnk_ent`` its
    link entries as ``(l * 3 + k) * 2 + side``, whose sign is + for side 1
    (``idx1``) and - for side 0, each row ascending. Links that anchor
    points to fixed targets (``idx0`` and ``bary0`` None, as in the match
    rounds) weigh nothing on side 0 and list only side 1; the links that
    ``keep`` (L,) leaves out (weighed 0 in every solve, such as padding)
    list no entry. Adds the counts ``nt`` and ``nl`` and the kernel's lanes
    a vertex ``group`` (``operator_group`` over the links listed: their
    count ``n_kept`` where the caller knows it, else read from ``keep``,
    one sync)."""
    tris = tris.reshape(-1, 3)
    idx1, bary1 = idx1.reshape(-1, 3), bary1.reshape(-1, 3)
    one_sided = idx0 is None
    if one_sided:
        idx0, bary0 = idx1, torch.zeros_like(bary1)
    nt, nl = tris.shape[0], idx1.shape[0]
    if keep is None:
        n_kept = nl
    elif n_kept is None:
        n_kept = int(keep.sum())
    out = {'nv': int(nv), 'nt': nt, 'nl': nl,
           'group': operator_group(nv, nt, n_kept,
                                   sides=1 if one_sided else 2)}
    order, ptr = _sorted_rows(tris, nv)
    out['inc_ptr'], out['inc_ent'] = ptr.to(torch.int32), order.to(torch.int32)
    # points that list no entry sort past the last vertex, outside every row
    pts = torch.stack([torch.full_like(idx1, nv) if one_sided
                       else idx0.reshape(-1, 3), idx1], -1)
    if keep is not None:
        pts = torch.where(keep[:, None, None], pts, nv)
    order, ptr = _sorted_rows(pts, nv)
    out['lnk_ptr'], out['lnk_ent'] = ptr.to(torch.int32), order.to(torch.int32)
    out['tris'] = tris.to(torch.int32).contiguous()
    out['idx0'] = idx0.reshape(-1, 3).to(torch.int32).contiguous()
    out['idx1'] = idx1.to(torch.int32).contiguous()
    out['bary0'] = bary0.reshape(-1, 3).contiguous()
    out['bary1'] = bary1.contiguous()
    return out


# the tables in the order the kernel reads their addresses
_TABLE_KEYS = ('tris', 'inc_ptr', 'inc_ent', 'lnk_ptr', 'lnk_ent', 'idx0',
               'bary0', 'idx1', 'bary1')
# the kernel's lanes a vertex (csrc/fem_operator.cu instantiates these)
OPERATOR_GROUPS = (4, 8, 16, 32)


def operator_group(nv, nt, nl, sides=2):
    """The kernel's lanes a vertex G for a system of ``nv`` vertices, ``nt``
    elements and ``nl`` links listed on ``sides`` sides: the smallest power
    of two, 4 to 32, that is at least the mean CSR entries a vertex (3 NT +
    3 sides L element corners and link entries over NV), so that a lane
    takes about one of them."""
    mean = (3 * nt + 3 * sides * nl) / max(nv, 1)
    return next((g for g in OPERATOR_GROUPS if g >= mean),
                OPERATOR_GROUPS[-1])


def elastic_operator_plain(x, Ke, tables, weight, free, lam_s, lam_c):
    """free * (lam_s K x + lam_c C^T W^2 C x), K through
    ``stiffness_matvec``, the links through ``crosslink_matvec``."""
    t = tables
    y = stiffness_matvec(x, Ke, t['tris'])
    c = crosslink_matvec(x, t['idx0'], t['bary0'], t['idx1'], t['bary1'],
                         weight)
    return free * (lam_s * y + lam_c * c)


_LIBS = {}


def _operator_lib():
    if 'fem_operator' not in _LIBS:
        # x, Ke, the tables' pointers, weight, free, lam_s, lam_c, y; nv,
        # group; stream
        args = ([ctypes.c_void_p] * 5 + [ctypes.c_double] * 2
                + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        _LIBS['fem_operator'] = build.bind('fem_operator', {
            'fem_operator_f32': args, 'fem_operator_f64': args,
            'fem_operator_attrs': [ctypes.c_int] * 2 + [ctypes.c_void_p]})
    return _LIBS['fem_operator']


def operator_kernel_attrs(dtype, group):
    """What the card's runtime reports for the operator's kernel at G =
    ``group`` lanes a vertex: {'registers', 'local_bytes' (spills),
    'shared_bytes', 'blocks_per_sm'} (its blocks resident on one SM)."""
    out = (ctypes.c_int * 4)()
    err = _operator_lib().fem_operator_attrs(
        int(dtype == torch.float64), int(group), out)
    if err != 0:
        raise RuntimeError(f'fem_operator_attrs failed: CUDA error {err}')
    return dict(zip(('registers', 'local_bytes', 'shared_bytes',
                     'blocks_per_sm'), out))


def bind_elastic_operator(Ke, tables, weight, free, lam_s, lam_c):
    """The general CG operator of one solve: x -> ``elastic_operator_plain(x,
    Ke, tables, weight, free, lam_s, lam_c)``. Everything but x stays fixed
    over a solve's iterations, so it is checked once, here, and each call
    checks only x. On tables on a CUDA device each call launches the kernel
    (f32 or f64) at ``tables['group']`` lanes a vertex; on tables on the
    CPU it runs the plain version. Ke: (NT, 6, 6); tables:
    ``operator_tables``'; weight: (L,); free: (NV, 1), all on the
    tables' device in their dtype; x: (NV, 2) likewise. Each call returns y
    (NV, 2)."""
    t = tables
    nv, nt, nl = t['nv'], t['nt'], t['nl']
    dev, dtype = t['bary0'].device, t['bary0'].dtype
    if dev.type == 'cpu':
        return lambda x: elastic_operator_plain(x, Ke, t, weight, free,
                                                lam_s, lam_c)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f'elastic operator: unsupported dtype {dtype}')
    for key, a, shape in (('Ke', Ke, (nt, 6, 6)), ('weight', weight, (nl,)),
                          ('free', free, (nv, 1))):
        if (a.device != dev or a.dtype != dtype or not a.is_contiguous()
                or a.shape != shape):
            raise ValueError(f'elastic operator: {key} must be a contiguous '
                             f'{dtype} tensor of shape {shape} on {dev}')
    # the kernel reads Ke in 16-byte rows and x in pairs
    if Ke.data_ptr() % 16:
        raise ValueError('elastic operator: Ke must be aligned to 16 bytes')
    pair = 2 * Ke.element_size()
    fn = getattr(_operator_lib(), 'fem_operator_f32' if dtype == torch.float32
                 else 'fem_operator_f64')
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    for k in _TABLE_KEYS:
        want = dtype if k.startswith('bary') else torch.int32
        if (t[k].device != dev or t[k].dtype != want
                or not t[k].is_contiguous()):
            raise ValueError(f'elastic operator: table {k} must be a '
                             f'contiguous {want} tensor on {dev}')
    ptrs = (ctypes.c_void_p * len(_TABLE_KEYS))(
        *(t[k].data_ptr() for k in _TABLE_KEYS))
    fixed = (Ke.data_ptr(), ptrs, weight.data_ptr(), free.data_ptr(),
             float(lam_s), float(lam_c))
    group = t['group']

    def matvec(x):
        if (x.device != dev or x.dtype != dtype or x.shape != (nv, 2)
                or not x.is_contiguous() or x.data_ptr() % pair):
            raise ValueError(f'elastic operator: x must be a contiguous '
                             f'{dtype} tensor of shape {(nv, 2)} on {dev}, '
                             'aligned to a row')
        y = torch.empty_like(x)
        if nv == 0:
            return y
        err = device_mod.launch_on(index, fn, x.data_ptr(), *fixed,
                                   y.data_ptr(), nv, group)
        if err != 0:
            raise RuntimeError(f'fem_operator launch failed: CUDA error {err}')
        device_mod.count_launch('fem_operator', (nv, nt, nl))
        return y
    # the tensors whose addresses the calls pass on
    matvec.inputs = (Ke, t, weight, free, ptrs)
    return matvec


# ------------------------------ PCG solver ------------------------------ #

# iterations between host checks for "every system stopped"
_CHECK_EVERY = 8


def cg_solve(matvec, b, diag=None, x0=None, tol=1e-7, atol=0.0, maxiter=1000,
             chances=None, precond=None):
    """Jacobi-preconditioned conjugate gradients with best-so-far tracking.

    ``b`` is (NV, 2), or (P, NV, 2) for P independent systems whose
    ``matvec`` acts on the stacked array. Each system stops on
    ||r|| <= max(tol*||b||, atol), after ``maxiter`` iterations, or --
    with ``chances`` -- after that many consecutive iterations without
    residual improvement; a stopped system's state is frozen while the
    others run on. The host checks for "all stopped" every
    ``_CHECK_EVERY`` iterations, which only changes how many frozen
    iterations run, never the result. The returned x is each system's
    best-so-far iterate by residual norm. Returns (x_best, iterations,
    best_residual_norm), the last two per system. Adds one to the counter
    ``solver.cg_calls`` and the loop trips the host ran (frozen systems'
    included) to ``solver.cg_iters``.
    """
    single = b.dim() == 2
    if single:
        b = b[None]
        inner_mv = matvec
        matvec = lambda v: inner_mv(v[0])[None]  # noqa: E731
        if diag is not None:
            diag = diag[None]
        if x0 is not None:
            x0 = x0[None]
        if precond is not None:
            inner_pc = precond
            precond = lambda v: inner_pc(v[0])[None]  # noqa: E731
    x0 = torch.zeros_like(b) if x0 is None else x0
    if diag is None:
        minv = torch.ones_like(b)
    else:
        ok = diag > 1e-12
        minv = torch.where(ok, 1.0 / torch.where(ok, diag, 1.0), 1.0)
    if precond is None:
        precond = lambda r: minv * r  # noqa: E731

    def dot(a, c):
        return (a * c).sum(dim=(1, 2))

    def norm(a):
        return torch.sqrt(dot(a, a))

    bnorm = norm(b)
    limit = torch.clamp(tol * bnorm, min=atol)
    max_stall = maxiter + 1 if chances is None else int(chances)
    trips = 0
    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = dot(r, z)
    x = x0
    best_x = x0
    best_rn = norm(r)
    it = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    stall = torch.zeros_like(it)
    rn = best_rn
    for k in range(int(maxiter)):
        active = (it < maxiter) & (rn > limit) & (stall <= max_stall)
        if k % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        trips += 1
        a3 = active[:, None, None]
        Ap = matvec(p)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
        x_new = x + alpha[:, None, None] * p
        r_new = r - alpha[:, None, None] * Ap
        z = precond(r_new)
        rz_new = dot(r_new, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        p_new = z + beta[:, None, None] * p
        rn_new = norm(r_new)
        improved = (rn_new < best_rn) & active
        best_x = torch.where(improved[:, None, None], x_new, best_x)
        best_rn = torch.where(improved, rn_new, best_rn)
        stall = torch.where(active, torch.where(improved, 0, stall + 1), stall)
        x = torch.where(a3, x_new, x)
        r = torch.where(a3, r_new, r)
        p = torch.where(a3, p_new, p)
        rz = torch.where(active, rz_new, rz)
        rn = torch.where(active, rn_new, rn)
        it = it + active.to(it.dtype)
    trace.count('solver.cg_calls')
    trace.count('solver.cg_iters', trips)
    if single:
        return best_x[0], it[0], best_rn[0]
    return best_x, it, best_rn
