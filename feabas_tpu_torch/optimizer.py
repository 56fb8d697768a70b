"""Spring-linked-mesh optimization (counterpart of
``feabas_tpu/optimizer.py``).

`Link` stores point correspondences between two meshes as (triangle,
barycentric) anchors; `SLM` bundles meshes + links and runs per-mesh
translation least squares (host), the affine cascade (host) and the
elastic solve on the device, matrix-free (``ops.fem``): the fused
linear-ENG solve, the general path (stiffness curves, SVK and NHK
elements, positive lambdas, strained meshes with no link, tile groups
sharing one deformation), whose CG operator is the hand-written kernel
bound by ``ops.fem.bind_elastic_operator``, and Newton-Raphson over it for
nonlinear materials. ``coarse_mesh_SLM`` relaxes a coarse surrogate
system. The solver dtype and device are explicit: ``SLM(meshes,
dtype=torch.float32, device=...)``.
"""

import numpy as np
import scipy.sparse as sparse
import torch

from feabas_tpu_torch import constant as const
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch.ops import fem


def _sparse_spd_solve(A, b, diag, rtol=1e-10, maxiter=2000):
    """Solve the SPD sparse system A x = b (b may be (n, k)) with
    Jacobi-preconditioned CG; small systems go through a dense solve.
    Returns None on failure (host)."""
    n = A.shape[0]
    b = np.atleast_2d(np.asarray(b, np.float64))
    if b.shape[0] != n:
        b = b.T
    if n <= 256:
        try:
            return np.linalg.lstsq(A.toarray(), b, rcond=None)[0]
        except np.linalg.LinAlgError:
            return None
    from scipy.sparse.linalg import cg as sp_cg, lsqr as sp_lsqr
    M = sparse.diags(1.0 / np.maximum(diag, 1e-12))
    out = np.empty_like(b)
    for k in range(b.shape[1]):
        x, info = sp_cg(A, b[:, k], M=M, rtol=rtol, maxiter=maxiter)
        if info != 0:
            x = sp_lsqr(A, b[:, k], atol=rtol, btol=rtol)[0]
        out[:, k] = x
    return out


def _solver_log():
    import logging as _logging
    return _logging.getLogger('feabas_tpu_torch.solver')


def _flat_translation_precond(offsets_arr, agg, mesh_free, idx0, idx1,
                              weight, lam_c, diag, free):
    """Two-level preconditioner: Jacobi plus the exact inverse of the
    (M, M) crosslink Laplacian over per-mesh translations (the slow CG
    modes). Returns a ``cg_solve`` precond callable or None."""
    M = mesh_free.shape[0]
    if M < 2 or M > 1024:
        return None
    dtype = diag.dtype
    m0 = torch.searchsorted(offsets_arr, idx0[:, 0].contiguous(), right=True) - 1
    m1 = torch.searchsorted(offsets_arr, idx1[:, 0].contiguous(), right=True) - 1
    w2 = ((weight ** 2) * lam_c).to(dtype)
    Ac = fem.fixed_sum(torch.cat([m0 * M + m0, m1 * M + m1, m0 * M + m1,
                                  m1 * M + m0]), M * M)(
        torch.cat([w2, w2, -w2, -w2])).reshape(M, M)
    mask2 = mesh_free[:, None] * mesh_free[None, :]
    Ac = torch.where(mask2 > 0, Ac, 0.0)
    reg = torch.clamp(torch.diagonal(Ac).max(), min=1.0)
    Ac = Ac + torch.diag(torch.where(mesh_free > 0, 1e-6 * reg, reg))
    Acinv = torch.linalg.inv(Ac)
    ok = diag > 1e-12
    minv = torch.where(ok, 1.0 / torch.where(ok, diag, 1.0), 1.0)
    starts = offsets_arr[:-1]
    stops = offsets_arr[1:]

    def precond(r):
        cs = torch.cat([torch.zeros((1, 2), dtype=r.dtype, device=r.device),
                        torch.cumsum(r, dim=0)])
        rc = cs[stops] - cs[starts]
        cc = (Acinv @ rc) * mesh_free[:, None]
        return r * minv + cc[agg] * free

    return precond


def _mode_projector(modes):
    """Orthogonal projector removing the span of orthonormal ``modes``
    (K, NV, 2): deflates the rigid modes of fully-free components."""
    if modes is None:
        return lambda x: x

    def project(x):
        coef = torch.tensordot(modes, x, dims=([1, 2], [0, 1]))
        return x - torch.tensordot(coef, modes, dims=([0], [0]))

    return project


def rigid_modes_flat(n_slots, components):
    """Orthonormal rigid modes (tx, ty, infinitesimal rotation about the
    component centroid) over a flattened (n_slots, 2) DOF layout; host."""
    modes = []
    for rows, q in components:
        rows = np.asarray(rows)
        if rows.size == 0:
            continue
        m1 = np.zeros((n_slots, 2))
        m1[rows, 0] = 1.0 / np.sqrt(rows.size)
        m2 = np.zeros((n_slots, 2))
        m2[rows, 1] = 1.0 / np.sqrt(rows.size)
        modes.extend([m1, m2])
        qc = np.asarray(q, np.float64) - np.asarray(q, np.float64).mean(axis=0)
        nrm = np.linalg.norm(qc)
        if nrm > 0:
            m3 = np.zeros((n_slots, 2))
            m3[rows, 0] = -qc[:, 1] / nrm
            m3[rows, 1] = qc[:, 0] / nrm
            modes.append(m3)
    if not modes:
        return None
    return np.stack(modes)


def _linear_solve_eng(tables, tris, B, area2, multiplier, poisson,
                      idx0, bary0, idx1, bary1, weight,
                      pos_start, pos_shape, free,
                      lam_ratio, tol, atol, maxiter,
                      offsets_arr=None, agg=None, mesh_free=None,
                      modes=None):
    """Fused elastic solve for linear-ENG elements: assembles element
    blocks, trace-balances the stiffness lambda, builds rhs/diag and runs
    PCG. The CG matvec is the operator ``fem.bind_elastic_operator`` binds
    to ``tables`` (``fem.operator_tables``' over ``tris`` and the links)
    with the balanced lambda (read to the host once a solve); every other
    sum onto vertices runs in a fixed order (``fem.fixed_sum``), so a
    solve on the card gives the same bits every run. Returns (NV+2, 2): dx
    rows, then [[bnorm, res], [cost0, iters]]."""
    nv = pos_start.shape[0]
    Ke = fem.eng_element_stiffness(B, area2, multiplier, poisson)
    u_cur = pos_start - pos_shape
    by_corner = fem.fixed_sum(tris, nv)
    push = fem.link_sum(idx0, idx1, nv)
    dC = fem.link_diag(push, bary0, bary1, weight)
    dK = by_corner(torch.diagonal(Ke, dim1=1, dim2=2).reshape(-1, 2))
    tr_c = dC.sum()
    tr_k = torch.where(dC != 0, dK, 0.0).sum()
    ok = (tr_c > 0) & (tr_k > 0)
    lam_s = torch.where(ok, lam_ratio * tr_c / torch.where(tr_k > 0, tr_k, 1.0),
                        1.0)
    lam_c = 1.0
    project = _mode_projector(modes)
    operator = fem.bind_elastic_operator(Ke.contiguous(), tables, weight,
                                         free, float(lam_s), lam_c)

    def matvec(x):
        return project(operator(project(x * free)))

    r0 = (fem.link_eval(pos_start, idx1, bary1)
          - fem.link_eval(pos_start, idx0, bary0))
    rw = r0 * (weight ** 2)[:, None] * lam_c
    b = (-fem.link_transpose(push, bary0, bary1, rw)
         - lam_s * by_corner(torch.einsum('nij,nj->ni', Ke,
                                          fem.gather_uv(u_cur, tris))
                             .reshape(-1, 2)))
    b = project(b * free)
    diag = dK * lam_s + dC * lam_c
    diag = torch.where(free > 0, diag, 1.0)
    precond = None
    if agg is not None:
        inner = _flat_translation_precond(offsets_arr, agg, mesh_free, idx0,
                                          idx1, weight, lam_c, diag, free)
        if inner is not None:
            precond = lambda r: project(inner(project(r)))  # noqa: E731
    dx, n_it, res = fem.cg_solve(matvec, b, diag=diag, tol=tol, atol=atol,
                                 maxiter=maxiter, precond=precond)
    dx = project(dx)
    cost0 = torch.linalg.norm(r0 * weight[:, None])
    stats = torch.stack([torch.stack([torch.linalg.norm(b), res]),
                         torch.stack([cost0, n_it.to(dx.dtype)])])
    return torch.cat([dx * free, stats.to(dx.dtype)], dim=0)


class Link:
    """Point correspondences between two meshes, anchored as (tid,
    barycentric) pairs at the INITIAL gear; ``weight`` is the static
    match confidence, ``residue_weight`` the robust damping factor."""

    def __init__(self, mesh0, mesh1, tid0, bary0, tid1, bary1, weight=None,
                 name=None, strain=np.nan):
        self.meshes = (mesh0, mesh1)
        self.strain = float(strain) if strain is not None else np.nan
        self._tid0 = np.asarray(tid0, dtype=np.int64)
        self._bary0 = np.asarray(bary0, dtype=np.float64)
        self._tid1 = np.asarray(tid1, dtype=np.int64)
        self._bary1 = np.asarray(bary1, dtype=np.float64)
        n = self._tid0.shape[0]
        self._weight = (np.ones(n) if weight is None
                        else np.asarray(weight, np.float64).ravel())
        self.residue_weight = np.ones(n)
        self._disabled = False
        self._name = name

    @classmethod
    def from_coordinates(cls, mesh0, mesh1, xy0, xy1, weight=None,
                         gear=(const.MESH_GEAR_INITIAL, const.MESH_GEAR_INITIAL),
                         **kwargs):
        xy0 = np.asarray(xy0, np.float64).reshape(-1, 2)
        xy1 = np.asarray(xy1, np.float64).reshape(-1, 2)
        tmode = kwargs.pop('trifinder_mode', None)
        tmode0 = tmode if tmode is not None else (
            const.MESH_TRIFINDER_LEAST_DEFORM
            if mesh0.likely_collisions(gear[0]) else None)
        tmode1 = tmode if tmode is not None else (
            const.MESH_TRIFINDER_LEAST_DEFORM
            if mesh1.likely_collisions(gear[1]) else None)
        tid0 = mesh0.tri_finder(xy0, gear=gear[0], extrapolate=True,
                                mode=tmode0)
        tid1 = mesh1.tri_finder(xy1, gear=gear[1], extrapolate=True,
                                mode=tmode1)
        bary0 = mesh0.cart2bary(xy0, tid0, gear=gear[0])
        bary1 = mesh1.cart2bary(xy1, tid1, gear=gear[1])
        # points extrapolated far outside their triangle are dropped
        ok = (np.abs(bary0).max(axis=-1) < 3) & (np.abs(bary1).max(axis=-1) < 3)
        if weight is not None:
            weight = np.asarray(weight, np.float64).ravel()[ok]
        return cls(mesh0, mesh1, tid0[ok], bary0[ok], tid1[ok], bary1[ok],
                   weight=weight, **kwargs)

    @property
    def name(self):
        if self._name is None:
            return f'{self.meshes[0].name or int(self.meshes[0].uid)}__to__' \
                   f'{self.meshes[1].name or int(self.meshes[1].uid)}'
        return self._name

    @property
    def num_matches(self):
        return 0 if self._disabled else self._tid0.shape[0]

    @property
    def uids(self):
        return (self.meshes[0].uid, self.meshes[1].uid)

    @property
    def disabled(self):
        return self._disabled

    def disable(self):
        self._disabled = True

    def enable(self):
        self._disabled = False

    def weight(self):
        return self._weight * self.residue_weight

    def xy0(self, gear=const.MESH_GEAR_MOVING):
        return self.meshes[0].bary2cart(self._tid0, self._bary0, gear=gear)

    def xy1(self, gear=const.MESH_GEAR_MOVING):
        return self.meshes[1].bary2cart(self._tid1, self._bary1, gear=gear)

    def dxy(self, gear=const.MESH_GEAR_MOVING):
        """Residual vectors xy1 - xy0 at a gear (world units)."""
        g0, g1 = gear if isinstance(gear, (tuple, list)) else (gear, gear)
        return self.xy1(gear=g1) - self.xy0(gear=g0)

    def residues(self, gear=const.MESH_GEAR_MOVING):
        return np.linalg.norm(self.dxy(gear=gear), axis=-1)

    def spacing(self):
        """Median nearest-neighbour spacing of the match points (INITIAL
        coords); scales the residue-smoothing kernel."""
        xy0 = self.xy0(gear=const.MESH_GEAR_INITIAL)
        if xy0.shape[0] < 2:
            return 1.0
        from scipy.spatial import cKDTree
        d, _ = cKDTree(xy0).query(xy0, k=2)
        return float(np.median(d[:, 1])) or 1.0

    def smooth_matrix(self, sigma=None):
        """Gaussian neighbourhood-weight sparse matrix over the match points
        (pairs within 2.5 sigma, sigma default 3x the spacing); cached per
        sigma. None when no pair is that close."""
        if sigma is None:
            sigma = 3.0 * self.spacing()
        cache = getattr(self, '_dis_smooth_matrix', None)
        if cache is None:
            cache = self._dis_smooth_matrix = {}
        if sigma not in cache:
            from scipy.spatial import cKDTree
            xy0 = self.xy0(gear=const.MESH_GEAR_INITIAL)
            n = xy0.shape[0]
            pairs = cKDTree(xy0).query_pairs(2.5 * sigma,
                                             output_type='ndarray')
            if pairs.size == 0:
                cache[sigma] = None
            else:
                w = np.exp(-np.sum((xy0[pairs[:, 0]] - xy0[pairs[:, 1]]) ** 2,
                                   axis=-1) / sigma ** 2)
                m = sparse.csr_matrix((w, (pairs[:, 0], pairs[:, 1])),
                                      shape=(n, n))
                cache[sigma] = m + m.T
        return cache[sigma]

    def dxy_smoothen(self, gear=const.MESH_GEAR_MOVING, sigma=None):
        """Weight-averaged residual vectors over each match's neighbourhood:
        the locally coherent part of the residue field (NaN where a match
        has no weighted neighbour)."""
        dxy = self.dxy(gear=gear)
        mtx = self.smooth_matrix(sigma=sigma)
        if mtx is None:
            return np.zeros_like(dxy)
        wt = self.weight()
        wv = mtx.dot(wt)
        out = np.full_like(dxy, np.nan)
        ok = wv > 0
        out[ok, 0] = mtx.dot(dxy[:, 0] * wt)[ok] / wv[ok]
        out[ok, 1] = mtx.dot(dxy[:, 1] * wt)[ok] / wv[ok]
        return out

    def spatial_autocorrelation(self, gear=const.MESH_GEAR_MOVING,
                                sigma=None):
        """1 when the residues vary smoothly in space (a coherent offset
        field), ~0 when they are spatially uncorrelated (noise)."""
        if self.smooth_matrix(sigma=sigma) is None:
            return 0.0
        dxy = self.dxy(gear=gear)
        dxy_sm = self.dxy_smoothen(gear=gear, sigma=sigma)
        wt = self.weight()
        rr = np.sum((dxy - dxy_sm) ** 2, axis=-1) \
            / np.maximum(np.sum(dxy ** 2, axis=-1)
                         + np.sum(dxy_sm ** 2, axis=-1), 1e-12)
        ok = np.isfinite(rr) & (wt > 0)
        if not ok.any():
            return 0.0
        return float(1.0 - np.average(rr[ok], weights=wt[ok]))

    def adjust_weight_from_residue(self, gear=const.MESH_GEAR_MOVING,
                                   residue_len=0, residue_mode=None):
        """Robust reweighting: 'huber' damps by residue_len/|r|;
        'threshold' zeroes matches beyond residue_len; 'huber_smooth'
        measures each residue against the locally smoothed residue field
        (``dxy_smoothen``), so a coherent offset cluster keeps its weight
        while incoherent outliers are damped. Returns (changed,
        fraction_kept)."""
        if residue_mode is None or residue_len <= 0 or self.num_matches == 0:
            return False, 1.0
        r = self.residues(gear=gear)
        if residue_mode == 'huber':
            new_w = np.clip(residue_len / np.clip(r, 1e-9, None), None, 1.0)
        elif residue_mode == 'threshold':
            new_w = (r <= residue_len).astype(np.float64)
        elif residue_mode == 'huber_smooth':
            dev = self.dxy(gear=gear) - np.nan_to_num(
                self.dxy_smoothen(gear=gear))
            r_dev = np.linalg.norm(dev, axis=-1)
            new_w = np.clip(residue_len / np.clip(r_dev, 1e-9, None),
                            None, 1.0)
        else:
            raise ValueError(f'unknown residue mode {residue_mode}')
        changed = not np.allclose(new_w, self.residue_weight)
        self.residue_weight = new_w
        kept = float((self.weight() > 0).mean()) if new_w.size else 1.0
        return changed, kept

    def reset_residue_weight(self):
        self.residue_weight = np.ones(self._tid0.shape[0])

    def global_arrays(self, offset0, offset1):
        """(idx0, bary0, idx1, bary1, weight) with global vertex indices."""
        m0, m1 = self.meshes
        idx0 = m0.triangles[self._tid0] + offset0
        idx1 = m1.triangles[self._tid1] + offset1
        return idx0, self._bary0, idx1, self._bary1, self.weight()


def distribute_link(mesh0_list, mesh1_list, xy0, xy1, weight=None,
                    gear=const.MESH_GEAR_INITIAL, exclusive=True, **kwargs):
    """Distribute one link's matches over split meshes: each match goes to
    the component pair that contains its two endpoints. Returns a list of
    Links."""
    xy0 = np.asarray(xy0, np.float64).reshape(-1, 2)
    xy1 = np.asarray(xy1, np.float64).reshape(-1, 2)
    n = xy0.shape[0]
    weight = np.ones(n) if weight is None else np.asarray(weight).ravel()
    remaining = np.arange(n)
    out = []
    for m0 in mesh0_list:
        if remaining.size == 0:
            break
        tid0 = m0.tri_finder(xy0[remaining], gear=gear)
        in0 = tid0 >= 0
        if not in0.any():
            continue
        cand0 = remaining[in0]
        for m1 in mesh1_list:
            if cand0.size == 0:
                break
            tid1 = m1.tri_finder(xy1[cand0], gear=gear)
            take = cand0[tid1 >= 0]
            if take.size == 0:
                continue
            link = Link.from_coordinates(m0, m1, xy0[take], xy1[take],
                                         weight=weight[take],
                                         gear=(gear, gear), **kwargs)
            if link.num_matches > 0:
                out.append(link)
            if exclusive:
                cand0 = np.setdiff1d(cand0, take)
                remaining = np.setdiff1d(remaining, take)
    return out


class SLM:
    """A system of meshes coupled by links, solved on one torch device."""

    def __init__(self, meshes=None, links=None, dtype=torch.float32,
                 device=None, **kwargs):
        self.meshes = list(meshes) if meshes else []
        self.links = list(links) if links else []
        self._stiffness_lambda = kwargs.get('stiffness_lambda', 1.0)
        self._crosslink_lambda = kwargs.get('crosslink_lambda', 1.0)
        self.dtype = dtype
        self.device = device_mod.get_device(device)

    # ------------------------- bookkeeping ------------------------- #

    def add_mesh(self, mesh):
        self.meshes.append(mesh)

    def mesh_by_uid(self, uid):
        for m in self.meshes:
            if m.uid == uid:
                return m
        raise KeyError(uid)

    def add_link(self, link, check_duplicates=False):
        self.links.append(link)

    def add_link_from_coordinates(self, uid0, uid1, xy0, xy1, weight=None,
                                  gear=(const.MESH_GEAR_INITIAL, const.MESH_GEAR_INITIAL),
                                  **kwargs):
        link = Link.from_coordinates(self.mesh_by_uid(uid0), self.mesh_by_uid(uid1),
                                     xy0, xy1, weight=weight, gear=gear, **kwargs)
        if link.num_matches > 0:
            self.links.append(link)
        return link

    @property
    def num_meshes(self):
        return len(self.meshes)

    @property
    def lock_flags(self):
        return np.asarray([m.locked for m in self.meshes], dtype=bool)

    def active_links(self):
        return [l for l in self.links if (not l.disabled) and l.num_matches > 0
                and np.any(l.weight() > 0)]

    def divide_disconnected_submeshes(self, prune_links=True):
        """Split every disconnected mesh into its components and
        redistribute its links onto them (``distribute_link``). Component
        uids extend the parent's with a 1e-3 step; components remember
        their parent for ``sync_component_positions``. Returns the number
        of meshes split."""
        replaced = {}
        new_meshes = []
        for m in self.meshes:
            if m.num_connected <= 1:
                new_meshes.append(m)
                continue
            comps = m.divide_disconnected_mesh()
            for k, c in enumerate(comps):
                c.uid = float(m.uid) + (k + 1) * 1e-3
                c.locked = m.locked
                c.soft_factor = m.soft_factor
            replaced[m.uid] = comps
            new_meshes.extend(comps)
        if not replaced:
            return 0
        self.meshes = new_meshes
        new_links = []
        for l in self.links:
            u0, u1 = l.uids
            if u0 not in replaced and u1 not in replaced:
                new_links.append(l)
                continue
            l0 = replaced.get(u0) or [self.mesh_by_uid(u0)]
            l1 = replaced.get(u1) or [self.mesh_by_uid(u1)]
            new_links.extend(distribute_link(
                l0, l1, l.xy0(gear=const.MESH_GEAR_INITIAL),
                l.xy1(gear=const.MESH_GEAR_INITIAL), weight=l.weight()))
        self.links = [l for l in new_links
                      if (not prune_links) or l.num_matches > 0]
        return len(replaced)

    def sync_component_positions(self, gear=const.MESH_GEAR_MOVING):
        """Write split-component positions back into their parent meshes
        (inverse of ``divide_disconnected_submeshes``)."""
        parents = {}
        for m in self.meshes:
            parent = getattr(m, '_parent_mesh', None)
            idx = getattr(m, '_parent_vertex_indices', None)
            if parent is None or idx is None:
                continue
            if id(parent) not in parents:
                if not parent.vertices_initialized(gear):
                    parent.set_vertices(parent.vertices(const.MESH_GEAR_FIXED),
                                        gear,
                                        offset=parent.offset(const.MESH_GEAR_FIXED))
                parents[id(parent)] = (parent,
                                       parent.vertices_w_offset(gear).copy())
            parents[id(parent)][1][idx] = m.vertices_w_offset(gear)
        for parent, mv in parents.values():
            center = mv.mean(axis=0, keepdims=True)
            parent.set_vertices(mv - center, gear, offset=center)
        return len(parents)

    def prune_links(self, min_matches=1):
        self.links = [l for l in self.links if l.num_matches >= min_matches]

    def clear_equation_terms(self):
        self._system = None

    def match_residues(self, gear=const.MESH_GEAR_MOVING, quantile=None):
        rr = [l.residues(gear=gear) for l in self.active_links()]
        if not rr:
            return np.zeros(0)
        r = np.concatenate(rr)
        if quantile is not None:
            return np.quantile(r, quantile)
        return r

    def mesh_connectivity(self):
        """Connected components of the mesh-link graph (labels per mesh)."""
        import scipy.sparse.csgraph as csgraph
        n = self.num_meshes
        uid2idx = {m.uid: i for i, m in enumerate(self.meshes)}
        rows, cols = [], []
        for l in self.active_links():
            u0, u1 = l.uids
            rows.append(uid2idx[u0])
            cols.append(uid2idx[u1])
        g = sparse.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
        _, labels = csgraph.connected_components(g, directed=False)
        return labels

    def flag_outcasts(self):
        """Flag meshes with no link path to an anchor: with any mesh locked,
        components holding no locked (and not previously outcast) mesh are
        outcasts; a fully free system keeps its largest component. Sets
        ``mesh.is_outcast`` and returns the boolean array."""
        labels = self.mesh_connectivity()
        lock_flags = np.asarray([m.locked for m in self.meshes], dtype=bool)
        prior = np.asarray([m.is_outcast for m in self.meshes], dtype=bool)
        if lock_flags.any():
            anchored_labels = labels[lock_flags & ~prior]
            outcasts = ~np.isin(labels, anchored_labels)
        elif labels.max() == 0:
            outcasts = np.zeros(self.num_meshes, dtype=bool)
        else:
            u, cnt = np.unique(labels, return_counts=True)
            outcasts = labels != u[np.argmax(cnt)]
        for m, flg in zip(self.meshes, outcasts):
            m.is_outcast = bool(flg)
        return outcasts

    # ------------------------- translation solve ------------------------- #

    def optimize_translation(self, **kwargs):
        """Per-mesh rigid translations minimizing weighted link residuals
        (host sparse least squares). Locked meshes are fixed; a component
        with no locked mesh has its mean translation pinned to zero."""
        target_gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
        start_gear = kwargs.get('start_gear', target_gear)
        n = self.num_meshes
        uid2idx = {m.uid: i for i, m in enumerate(self.meshes)}
        lock = self.lock_flags
        ii, jj, vv = [], [], []
        Atb = np.zeros((n, 2))
        for l in self.active_links():
            i0 = uid2idx[l.uids[0]]
            i1 = uid2idx[l.uids[1]]
            w2 = (l.weight() ** 2)
            sw = w2.sum()
            if sw <= 0:
                continue
            d = (l.dxy(gear=start_gear) * w2[:, None]).sum(axis=0)
            ii.extend((i0, i1, i0, i1))
            jj.extend((i0, i1, i1, i0))
            vv.extend((sw, sw, -sw, -sw))
            Atb[i0] += d
            Atb[i1] -= d
        AtA = sparse.coo_matrix(
            (np.asarray(vv, np.float64), (ii, jj)), shape=(n, n)).tocsr()
        labels = self.mesh_connectivity()
        t = np.zeros((n, 2))
        for lbl in np.unique(labels):
            sel = labels == lbl
            fixed = sel & lock
            free = sel & (~lock)
            if not free.any():
                continue
            fidx = np.flatnonzero(free)
            A = AtA[fidx][:, fidx].tocsr()
            b = Atb[fidx]
            diag = A.diagonal()
            if not fixed.any():
                ridge = max(diag.max(initial=0.0), 1.0) * 1e-8
                A = A + sparse.identity(A.shape[0], format='csr') * ridge
                diag = diag + ridge
            sol = _sparse_spd_solve(A, b, diag)
            if sol is None:
                continue
            if not fixed.any():
                sol = sol - sol.mean(axis=0, keepdims=True)
            t[free] = sol
        for m, ti, lk in zip(self.meshes, t, lock):
            if lk:
                if not m.vertices_initialized(target_gear):
                    m.set_vertices(m.vertices(start_gear), target_gear,
                                   offset=m.offset(start_gear))
                continue
            m.set_vertices(m.vertices(start_gear), target_gear,
                           offset=m.offset(start_gear) + ti)
        r = self.match_residues(gear=target_gear)
        return float(r.max()) if r.size else 0.0

    def optimize_translation_w_filtering(self, **kwargs):
        """Translation solve with iterative worst-link disabling."""
        residue_threshold = kwargs.pop('residue_threshold', None)
        maxpass = kwargs.pop('maxpass', 10)
        self.optimize_translation(**kwargs)
        if residue_threshold is None:
            return
        gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
        for _ in range(maxpass):
            worst, worst_val = None, residue_threshold
            for l in self.active_links():
                r = np.median(l.residues(gear=gear))
                if r > worst_val:
                    worst, worst_val = l, r
            if worst is None:
                break
            worst.disable()
            self.optimize_translation(**kwargs)

    # ------------------------- affine cascade ------------------------- #

    def optimize_affine_cascade(self, **kwargs):
        """Greedy per-mesh (or, with ``groupings``, per-group) affine
        placement: settled meshes (locked first, else the best-connected)
        anchor their neighbours, which are fitted by weighted affine on the
        link points and settle in turn. A fit whose singular values leave
        ``svd_clip`` falls back to its rigid part. Returns the max
        residue at the target gear."""
        groupings = kwargs.pop('groupings', None)
        if groupings is not None:
            return self._optimize_affine_grouped(np.asarray(groupings),
                                                 **kwargs)
        target_gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
        start_gear = kwargs.get('start_gear', const.MESH_GEAR_FIXED)
        svd_clip = kwargs.get('svd_clip', (0.5, 2.0))
        uid2idx = {m.uid: i for i, m in enumerate(self.meshes)}
        n = self.num_meshes
        settled = self.lock_flags.copy()
        for m in self.meshes:
            if not m.vertices_initialized(target_gear):
                m.set_vertices(m.vertices(start_gear), target_gear,
                               offset=m.offset(start_gear))
        links = self.active_links()
        if not settled.any() and n > 0:
            # seed: the mesh with the most matches
            counts = np.zeros(n)
            for l in links:
                counts[uid2idx[l.uids[0]]] += l.num_matches
                counts[uid2idx[l.uids[1]]] += l.num_matches
            settled[int(np.argmax(counts))] = True
        while not settled.all():
            # the unsettled mesh with the most match weight to settled ones
            score = np.zeros(n)
            pair_pts = {i: ([], [], []) for i in range(n)}
            for l in links:
                i0, i1 = uid2idx[l.uids[0]], uid2idx[l.uids[1]]
                if settled[i0] == settled[i1]:
                    continue
                if settled[i0]:
                    src = i1
                    p_src = l.xy1(gear=start_gear)
                    p_dst = l.xy0(gear=target_gear)
                else:
                    src = i0
                    p_src = l.xy0(gear=start_gear)
                    p_dst = l.xy1(gear=target_gear)
                w = l.weight()
                score[src] += w.sum()
                pair_pts[src][0].append(p_dst)
                pair_pts[src][1].append(p_src)
                pair_pts[src][2].append(w)
            score[settled] = -1
            nxt = int(np.argmax(score))
            if score[nxt] <= 0:
                # disconnected remainder keeps its start positions
                settled[:] = True
                break
            T = self._fit_clipped(np.concatenate(pair_pts[nxt][0]),
                                  np.concatenate(pair_pts[nxt][1]),
                                  np.concatenate(pair_pts[nxt][2]), svd_clip)
            self.meshes[nxt].apply_affine(T, gear=(start_gear, target_gear))
            settled[nxt] = True
        r = self.match_residues(gear=target_gear)
        return float(r.max()) if r.size else 0.0

    @staticmethod
    def _fit_clipped(p_dst, p_src, w, svd_clip):
        """Weighted affine p_src -> p_dst, or its rigid part when the
        singular values leave ``svd_clip``."""
        from feabas_tpu_torch import spatial as sp
        T, T_rigid = sp.fit_affine(p_dst, p_src, weights=w, return_rigid=True)
        s = np.linalg.svd(T[:2, :2], compute_uv=False)
        if svd_clip is not None and (s.min() < svd_clip[0]
                                     or s.max() > svd_clip[1]):
            return T_rigid
        return T

    def _optimize_affine_grouped(self, groupings, **kwargs):
        """Greedy affine cascade over mesh groups: links crossing group
        boundaries drive one weighted affine per group."""
        target_gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
        start_gear = kwargs.get('start_gear', const.MESH_GEAR_FIXED)
        svd_clip = kwargs.get('svd_clip', (0.5, 2.0))
        uid2idx = {m.uid: i for i, m in enumerate(self.meshes)}
        for m in self.meshes:
            if not m.vertices_initialized(target_gear):
                m.set_vertices(m.vertices(start_gear), target_gear,
                               offset=m.offset(start_gear))
        groups = np.unique(groupings)
        gsettled = {g: bool(np.any(self.lock_flags[groupings == g]))
                    for g in groups}
        links = self.active_links()
        if not any(gsettled.values()):
            counts = {g: 0 for g in groups}
            for l in links:
                counts[groupings[uid2idx[l.uids[0]]]] += l.num_matches
                counts[groupings[uid2idx[l.uids[1]]]] += l.num_matches
            gsettled[max(counts, key=counts.get)] = True
        while not all(gsettled.values()):
            score = {g: 0.0 for g in groups if not gsettled[g]}
            pts = {g: ([], [], []) for g in groups if not gsettled[g]}
            for l in links:
                g0 = groupings[uid2idx[l.uids[0]]]
                g1 = groupings[uid2idx[l.uids[1]]]
                if gsettled.get(g0) == gsettled.get(g1):
                    continue
                if gsettled[g0]:
                    src, p_dst, p_src = (g1, l.xy0(gear=target_gear),
                                         l.xy1(gear=start_gear))
                else:
                    src, p_dst, p_src = (g0, l.xy1(gear=target_gear),
                                         l.xy0(gear=start_gear))
                w = l.weight()
                score[src] += w.sum()
                pts[src][0].append(p_dst)
                pts[src][1].append(p_src)
                pts[src][2].append(w)
            if not score or max(score.values()) <= 0:
                for g in score:
                    gsettled[g] = True
                break
            nxt = max(score, key=score.get)
            T = self._fit_clipped(np.concatenate(pts[nxt][0]),
                                  np.concatenate(pts[nxt][1]),
                                  np.concatenate(pts[nxt][2]), svd_clip)
            for i in np.nonzero(groupings == nxt)[0]:
                if not self.meshes[i].locked:
                    self.meshes[i].apply_affine(T, gear=(start_gear,
                                                         target_gear))
            gsettled[nxt] = True
        r = self.match_residues(gear=target_gear)
        return float(r.max()) if r.size else 0.0

    # ------------------------- elastic solve (device) ------------------------- #

    def _tensor(self, a, dtype=None):
        if dtype is None and np.issubdtype(np.asarray(a).dtype, np.integer):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    def _build_system(self, shape_gear=const.MESH_GEAR_FIXED):
        """Concatenate the meshes into global tensors on the device."""
        offsets = np.cumsum([0] + [m.num_vertices for m in self.meshes])
        nv = int(offsets[-1])
        uid2off = {m.uid: offsets[i] for i, m in enumerate(self.meshes)}
        free = np.ones((nv, 1), np.float32)
        for i, m in enumerate(self.meshes):
            if m.locked:
                free[offsets[i]:offsets[i + 1]] = 0.0
        groups = []
        for i, m in enumerate(self.meshes):
            # per-mesh element groups depend only on the shape-gear
            # geometry: memoized on the mesh (invalidated by set_vertices)
            def _build(m=m):
                out = []
                for g in m.element_arrays(gear=shape_gear):
                    tris = np.asarray(m.triangles[g['start']:g['stop']])
                    out.append({
                        'model': g['model'],
                        'tris_local': self._tensor(tris),
                        'B_area': fem.shape_matrices(self._tensor(g['tripts'])),
                        'multiplier': self._tensor(g['multiplier']),
                        'poisson': self._tensor(g['poisson']),
                        'knots': g['knots'],
                    })
                return out

            cached = m._memo(shape_gear,
                             f'torch_element_groups_{self.dtype}_{self.device}',
                             _build)
            for g in cached:
                groups.append({**g, 'tris': g['tris_local'] + int(offsets[i])})
        la = [l.global_arrays(uid2off[l.uids[0]], uid2off[l.uids[1]])
              for l in self.active_links()]
        if la:
            links = tuple(np.concatenate([a[k] for a in la]) for k in range(5))
        else:
            links = (np.zeros((0, 3), np.int64), np.zeros((0, 3)),
                     np.zeros((0, 3), np.int64), np.zeros((0, 3)), np.zeros(0))
        return {
            'nv': nv, 'offsets': offsets,
            'free': self._tensor(free),
            'groups': groups,
            'links': tuple(self._tensor(a) for a in links),
        }

    def _rigid_deflation_modes(self, pos_shape):
        """Orthonormal rigid modes of every fully-free link-connected
        component, (K, NV, 2) in global numbering; None when every
        component holds a locked mesh."""
        n = self.num_meshes
        parent = list(range(n))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        uid2idx = {m.uid: i for i, m in enumerate(self.meshes)}
        for l in self.active_links():
            a, b = find(uid2idx[l.uids[0]]), find(uid2idx[l.uids[1]])
            if a != b:
                parent[a] = b
        offsets = np.cumsum([0] + [m.num_vertices for m in self.meshes])
        comp_locked = {}
        for i, m in enumerate(self.meshes):
            r = find(i)
            comp_locked[r] = comp_locked.get(r, False) or m.locked
        comps = []
        for r, locked in comp_locked.items():
            if locked:
                continue
            rows = np.concatenate([np.arange(offsets[i], offsets[i + 1])
                                   for i in range(n) if find(i) == r])
            comps.append((rows, pos_shape[rows]))
        return rigid_modes_flat(int(offsets[-1]), comps)

    def _gather_positions(self, gear):
        return np.concatenate([m.vertices_w_offset(gear) for m in self.meshes], axis=0)

    def _scatter_positions(self, pos, target_gear):
        offs = np.cumsum([0] + [m.num_vertices for m in self.meshes])
        for i, m in enumerate(self.meshes):
            if m.locked:
                continue
            chunk = pos[offs[i]:offs[i + 1]]
            center = chunk.mean(axis=0, keepdims=True)
            m.set_vertices(chunk - center, target_gear, offset=center)

    def _only_translated(self, shape_gear, start_gear):
        """True when every free mesh's ``start_gear`` vertices are its
        ``shape_gear`` vertices moved by one translation."""
        for m in self.meshes:
            if m.locked:
                continue
            d = m.vertices_w_offset(start_gear) \
                - m.vertices_w_offset(shape_gear)
            if np.abs(d - d[:1]).max() > 1e-9:
                return False
        return True

    @staticmethod
    def _element_terms(groups, u):
        """Tangent blocks and internal force per element group at the
        displacement u (NV, 2): a list of (tris, Ke, Pe)."""
        out = []
        for g in groups:
            B, area2 = g['B_area']
            uv = fem.gather_uv(u, g['tris'])
            mult = g['multiplier']
            if g['knots'] is not None:
                kx, ky = (torch.as_tensor(np.asarray(k), dtype=u.dtype,
                                          device=u.device)
                          for k in g['knots'])
                mult = mult * fem.stiffness_curve_multiplier(
                    fem.area_stretch(B, uv), kx, ky)
            if g['model'] == const.MATERIAL_MODEL_ENG:
                Ke = fem.eng_element_stiffness(B, area2, mult, g['poisson'])
                Pe = fem.eng_element_stress(Ke, uv)
            elif g['model'] == const.MATERIAL_MODEL_SVK:
                Ke, Pe = fem.svk_element(B, area2, uv, mult, g['poisson'])
            elif g['model'] == const.MATERIAL_MODEL_NHK:
                Ke, Pe = fem.nhk_element(B, area2, uv, mult)
            else:
                raise ValueError(f"unknown material model {g['model']}")
            out.append((g['tris'], Ke, Pe))
        return out

    def _vertex_sums(self, sys_d, terms):
        """The general path's sums onto vertices, each in a fixed order
        (``fem.fixed_sum``, so that a solve on the card takes the same
        iterations every run): (over the element corners of ``terms``,
        (3 NT, C) -> (NV, C); over the link points, idx1's then idx0's,
        (6 L, C) -> (NV, C))."""
        nv = sys_d['nv']
        idx0, _, idx1, _, _ = sys_d['links']
        return (fem.fixed_sum(torch.cat([t for t, _, _ in terms]), nv),
                fem.link_sum(idx0, idx1, nv))

    def _diagonals(self, sys_d, terms, sums):
        """(diag K, diag C^T W^2 C), (NV, 2) each, through ``sums``
        (``_vertex_sums``)."""
        by_corner, push = sums
        _, bary0, _, bary1, weight = sys_d['links']
        dK = by_corner(torch.cat([torch.diagonal(Ke, dim1=1, dim2=2)
                                  for _, Ke, _ in terms]).reshape(-1, 2))
        return dK, fem.link_diag(push, bary0, bary1, weight)

    def _balance_lambdas(self, sys_d, terms, lam_s, lam_c):
        """Negative lambdas -> trace-ratio balance: lam_s = |lam_s / lam_c|
        tr(C) / tr(K restricted to the crosslinked DOFs), lam_c = 1."""
        if lam_s >= 0 and lam_c >= 0:
            return float(lam_s), float(lam_c)
        ratio = abs(lam_s / lam_c)
        dK, dC = self._diagonals(sys_d, terms,
                                 self._vertex_sums(sys_d, terms))
        tr_c = float(dC.sum())
        tr_k = float(dK[dC != 0].sum())
        if tr_c == 0 or tr_k == 0:
            return 1.0, 1.0
        return abs(ratio * tr_c / tr_k), 1.0

    def _grouping_dof_map(self, groupings):
        """DOF map of the grouped solve: meshes of one group (one topology)
        share one deformation field. Returns (dof_map (NV,), ndof,
        group_locked (num_meshes,)); a group with any locked member is
        locked whole."""
        groupings = np.asarray(groupings).ravel()
        offsets = np.cumsum([0] + [m.num_vertices for m in self.meshes])
        dof_map = np.zeros(int(offsets[-1]), np.int64)
        reps = {}
        next_dof = 0
        glocked = {}
        for m, g in zip(self.meshes, groupings):
            glocked[g] = glocked.get(g, False) or m.locked
        for i, (m, g) in enumerate(zip(self.meshes, groupings)):
            if g not in reps:
                reps[g] = next_dof
                next_dof += m.num_vertices
            elif next_dof - reps[g] < m.num_vertices:
                raise ValueError('grouped meshes must share topology')
            dof_map[offsets[i]:offsets[i + 1]] = \
                reps[g] + np.arange(m.num_vertices)
        group_locked = np.asarray([glocked[g] for g in groupings], bool)
        return dof_map, next_dof, group_locked

    def _operator_tables(self, sys_d):
        """The CG operator's tables over every element group and link
        (``fem.operator_tables``') on the solver's device."""
        return fem.operator_tables(
            torch.cat([g['tris'] for g in sys_d['groups']]), sys_d['nv'],
            *sys_d['links'][:4])

    def _commit(self, pos_start, dx, target_gear):
        """Write pos_start + dx into target_gear; the weighted residue norm
        after it."""
        self._scatter_positions(pos_start + dx, target_gear)
        r1 = self.match_residues(gear=target_gear)
        w_all = np.concatenate([l.weight() for l in self.active_links()]) \
            if self.active_links() else np.zeros(0)
        return float(np.linalg.norm(r1 * w_all)) if r1.size else 0.0

    def optimize_linear(self, **kwargs):
        """One (tangent) elastic solve.

        Energy: lam_s/2 u'Ku + lam_c/2 |W C p|^2 over free meshes, u the
        displacement from the shape-gear geometry, p the world positions;
        negative lambdas are trace-balanced. All-ENG systems without
        stiffness curves, with links and negative lambdas, take the fused
        solve; every other system takes the general path, whose CG
        operator is ``fem.bind_elastic_operator``'s. With ``groupings``,
        meshes of one group share one deformation (the projected system
        P^T A P).
        Commits only when the solve converged (post-residual below ||b||);
        otherwise positions stay and ``last_solve_converged`` is False.
        Returns (cost_before, cost_after) as weighted residue norms.
        """
        tol = kwargs.get('tol', 1e-7)
        atol = kwargs.get('atol', 0.0)
        maxiter = kwargs.get('maxiter', None)
        maxiter = 10000 if maxiter is None else int(maxiter)
        chances = kwargs.get('chances', None)
        shape_gear = kwargs.get('shape_gear', const.MESH_GEAR_FIXED)
        target_gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
        start_gear = kwargs.get('start_gear', target_gear)
        lam_s = kwargs.get('stiffness_lambda', self._stiffness_lambda)
        lam_c = kwargs.get('crosslink_lambda', self._crosslink_lambda)
        groupings = kwargs.get('groupings', None)
        check_converge = kwargs.get('check_converge', True)
        if np.all(self.lock_flags) or self.num_meshes == 0:
            return 0.0, 0.0
        self.last_solve_converged = True
        sys_d = self._build_system(shape_gear=shape_gear)
        groups = sys_d['groups']
        n_links = sys_d['links'][4].shape[0]
        if n_links == 0 and self._only_translated(shape_gear, start_gear):
            # no link ties any mesh and none is strained: the right-hand
            # side is zero and positions stay (sections whose every pair
            # failed to match reach this)
            return 0.0, 0.0
        pos_start = self._gather_positions(start_gear)
        pos_shape = self._gather_positions(shape_gear)
        all_eng = all(g['model'] == const.MATERIAL_MODEL_ENG
                      and g['knots'] is None for g in groups)
        if (all_eng and groups and lam_s < 0 and lam_c < 0
                and groupings is None and n_links > 0):
            return self._fused_eng(sys_d, pos_start, pos_shape, lam_s / lam_c,
                                   tol, atol, maxiter, target_gear,
                                   check_converge)
        u_cur = self._tensor(pos_start - pos_shape)
        terms = self._element_terms(groups, u_cur)
        lam_s, lam_c = self._balance_lambdas(sys_d, terms, lam_s, lam_c)
        idx0, bary0, idx1, bary1, weight = sys_d['links']
        free = sys_d['free']
        if groupings is not None:
            dof_map, ndof, group_locked = self._grouping_dof_map(groupings)
            # group lock discipline: any locked member locks the group
            offs = sys_d['offsets']
            free = free.clone()
            for i, lk in enumerate(group_locked):
                if lk:
                    free[offs[i]:offs[i + 1]] = 0.0
            dof = self._tensor(dof_map)
        deflate = None if groupings is not None else \
            self._rigid_deflation_modes(pos_shape)
        proj = _mode_projector(None if deflate is None
                               else self._tensor(deflate))
        Ke = torch.cat([Ke for _, Ke, _ in terms]).contiguous()
        operator = fem.bind_elastic_operator(Ke, self._operator_tables(sys_d),
                                             weight, free, lam_s, lam_c)

        def matvec_full(x):
            return proj(operator(proj(x * free)))

        # rhs: -(lam_s P(u) + lam_c C^T W r) and the Jacobi diagonal
        sums = self._vertex_sums(sys_d, terms)
        by_corner, push = sums
        dK, dC = self._diagonals(sys_d, terms, sums)
        diag = lam_s * dK + lam_c * dC
        pos0 = self._tensor(pos_start)
        r0 = fem.link_eval(pos0, idx1, bary1) - fem.link_eval(pos0, idx0, bary0)
        rw = r0 * (weight ** 2)[:, None] * lam_c
        b = (-fem.link_transpose(push, bary0, bary1, rw)
             - lam_s * by_corner(torch.cat([Pe for _, _, Pe in terms])
                                 .reshape(-1, 2))) * free
        cost0 = float(torch.linalg.norm(r0 * weight[:, None]))
        if groupings is None:
            b = proj(b)
            diag = torch.where(free > 0, diag, 1.0)
            offs = sys_d['offsets']
            agg = np.repeat(np.arange(len(self.meshes)), np.diff(offs))
            mesh_free = np.asarray([0.0 if m.locked else 1.0
                                    for m in self.meshes])
            precond = _flat_translation_precond(
                self._tensor(offs), self._tensor(agg),
                self._tensor(mesh_free), idx0, idx1, weight, lam_c, diag,
                free)
            if precond is not None and deflate is not None:
                inner = precond
                precond = lambda r: proj(inner(proj(r)))  # noqa: E731
            dx, n_it, res = fem.cg_solve(matvec_full, b, diag=diag, tol=tol,
                                         atol=atol, maxiter=maxiter,
                                         chances=chances, precond=precond)
            bnorm = float(torch.linalg.norm(b))
            dx = proj(dx) * free
        else:
            # the projected system P^T A P, P the expansion by dof_map
            seg = fem.fixed_sum(dof, ndof)

            def matvec_s(xs):
                return seg(matvec_full(xs[dof]))

            b_s = seg(b)
            diag_s = seg(diag)
            diag_s = torch.where(diag_s > 0, diag_s, 1.0)
            dxs, n_it, res = fem.cg_solve(matvec_s, b_s, diag=diag_s, tol=tol,
                                          atol=atol, maxiter=maxiter,
                                          chances=chances)
            bnorm = float(torch.linalg.norm(b_s))
            dx = dxs[dof] * free
        res = float(res)
        _solver_log().debug('linear solve: %d CG iters, |b|=%.3e, res=%.3e',
                            int(n_it), bnorm, res)
        ok = res < bnorm or res <= max(tol * bnorm, atol)
        if check_converge and not ok:
            self.last_solve_converged = False
            return cost0, cost0
        dx = dx.cpu().numpy().astype(np.float64)
        return cost0, self._commit(pos_start, dx, target_gear)

    def _fused_eng(self, sys_d, pos_start, pos_shape, lam_ratio, tol, atol,
                   maxiter, target_gear, check_converge):
        """The fused linear-ENG solve (``_linear_solve_eng``) of
        ``optimize_linear``."""
        groups = sys_d['groups']
        idx0, bary0, idx1, bary1, weight = sys_d['links']
        deflate = self._rigid_deflation_modes(pos_shape)
        offs = sys_d['offsets']
        agg = np.repeat(np.arange(len(self.meshes)), np.diff(offs))
        mesh_free = np.asarray([0.0 if m.locked else 1.0 for m in self.meshes])
        packed = _linear_solve_eng(
            self._operator_tables(sys_d),
            torch.cat([g['tris'] for g in groups]),
            torch.cat([g['B_area'][0] for g in groups]),
            torch.cat([g['B_area'][1] for g in groups]),
            torch.cat([g['multiplier'] for g in groups]),
            torch.cat([g['poisson'] for g in groups]),
            idx0, bary0, idx1, bary1, weight,
            self._tensor(pos_start), self._tensor(pos_shape), sys_d['free'],
            abs(lam_ratio), tol, atol, int(maxiter),
            offsets_arr=self._tensor(offs), agg=self._tensor(agg),
            mesh_free=self._tensor(mesh_free),
            modes=None if deflate is None else self._tensor(deflate))
        packed = packed.cpu().numpy().astype(np.float64)
        dx = packed[:-2]
        bnorm, res = float(packed[-2, 0]), float(packed[-2, 1])
        cost0 = float(packed[-1, 0])
        _solver_log().debug('fused ENG solve: %d CG iters, |b|=%.3e, res=%.3e',
                            int(packed[-1, 1]), bnorm, res)
        ok = res < bnorm or res <= max(tol * bnorm, atol)
        if check_converge and not ok:
            self.last_solve_converged = False
            return cost0, cost0
        return cost0, self._commit(pos_start, dx, target_gear)

    def _snapshot_positions(self, gear):
        return [(m.vertices(gear).copy(), m.offset(gear).copy())
                for m in self.meshes]

    def _restore_positions(self, snap, gear):
        for m, (v, off) in zip(self.meshes, snap):
            m.set_vertices(v, gear, offset=off)

    def _count_flips(self, gear):
        return sum(int(m.flipped_triangles(gear).size)
                   for m in self.meshes if not m.locked)

    def optimize_Newton_Raphson(self, **kwargs):
        """Newton iterations for nonlinear materials: each step re-linearizes
        at the target gear and runs ``optimize_linear`` from it; the loop
        stops on a small cost change, a refused (diverged) solve, or after
        ``max_newtonstep`` steps.

        Flip guard: a step that adds flipped triangles is rolled back and
        retried with the crosslink lambda times ``crosslink_shrink`` (up to
        ``shrink_trial`` tries), a stiffer, smaller step. ``residue_mode``
        / ``residue_len`` reweight the links after each step;
        ``anneal_mode`` rebases the FIXED gear onto the solution after each
        step (after relaxing IQR-outlier deformation when
        ``deform_outlier_constant`` > 0). Returns (cost_before,
        cost_after)."""
        max_newtonstep = kwargs.pop('max_newtonstep', 5)
        crosslink_shrink = float(kwargs.pop('crosslink_shrink', 0.5))
        shrink_trial = int(kwargs.pop('shrink_trial', 3))
        deform_outlier_constant = kwargs.pop('deform_outlier_constant', 0)
        target_gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
        kwargs.setdefault('start_gear', target_gear)
        residue_mode = kwargs.pop('residue_mode', None)
        residue_len = kwargs.pop('residue_len', 0)
        anneal_mode = kwargs.pop('anneal_mode', None)
        for m in self.meshes:
            if not m.vertices_initialized(target_gear):
                m.set_vertices(m.vertices(kwargs['start_gear']), target_gear,
                               offset=m.offset(kwargs['start_gear']))
        cost0 = cost1 = None
        lam_c_base = kwargs.get('crosslink_lambda', self._crosslink_lambda)
        for _ in range(max(int(max_newtonstep), 1)):
            pre_flips = self._count_flips(target_gear)
            snap = self._snapshot_positions(target_gear)
            lam_c = lam_c_base
            for _ in range(max(shrink_trial, 1)):
                c0, c1 = self.optimize_linear(
                    **{**kwargs, 'start_gear': target_gear,
                       'crosslink_lambda': lam_c})
                if self._count_flips(target_gear) <= pre_flips:
                    break
                # new flips: roll back and take a stiffer, smaller step
                self._restore_positions(snap, target_gear)
                lam_c = lam_c * crosslink_shrink
            if cost0 is None:
                cost0 = c0
            if not getattr(self, 'last_solve_converged', True):
                break
            cost1 = c1
            if residue_mode is not None and residue_len > 0:
                for l in self.active_links():
                    l.adjust_weight_from_residue(gear=target_gear,
                                                 residue_len=residue_len,
                                                 residue_mode=residue_mode)
            if anneal_mode is not None:
                if deform_outlier_constant and deform_outlier_constant > 0:
                    for m in self.meshes:
                        if not m.locked:
                            relax_mesh_most_deformed(
                                m, iqr_factor=float(deform_outlier_constant),
                                dtype=self.dtype, device=self.device)
                for m in self.meshes:
                    if not m.locked:
                        m.anneal(gear=(target_gear, const.MESH_GEAR_FIXED),
                                 mode=anneal_mode)
            if c0 <= 0 or abs(c0 - c1) <= 1e-4 * max(c0, 1e-12):
                break
        return cost0 or 0.0, cost1 or 0.0

    @property
    def is_linear(self):
        for m in self.meshes:
            uid2mat = m.material_table.uid_to_material()
            for uid in np.unique(m.material_ids):
                mat = uid2mat.get(int(uid))
                if mat is not None and not mat.is_linear:
                    return False
        return True

    def optimize_elastic(self, **kwargs):
        """All-linear systems: one ``optimize_linear`` plus up to
        ``max_residue_passes`` residue reweighting passes, each followed by
        another solve. Nonlinear materials: ``optimize_Newton_Raphson``.
        Every other keyword (``groupings``, ``chances``, tolerances) goes on
        to ``optimize_linear``; ``chances`` stops the general path's CG
        after that many iterations without progress (the fused ENG solve
        ignores it, as the JAX package's does)."""
        if not self.is_linear:
            return self.optimize_Newton_Raphson(**kwargs)
        residue_mode = kwargs.pop('residue_mode', None)
        residue_len = kwargs.pop('residue_len', 0)
        max_passes = kwargs.pop('max_residue_passes', 3)
        out = self.optimize_linear(**kwargs)
        if residue_mode is not None and residue_len > 0:
            gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
            for _ in range(max_passes):
                changed = False
                for l in self.active_links():
                    ch, _ = l.adjust_weight_from_residue(
                        gear=gear, residue_len=residue_len,
                        residue_mode=residue_mode)
                    changed |= ch
                if not changed:
                    break
                out = (out[0], self.optimize_linear(**kwargs)[1])
        return out


def relax_mesh(mesh, free_vertices=None, dtype=torch.float32, device=None,
               **kwargs):
    """Locally relax a mesh: hold all vertices except ``free_vertices`` and
    minimize elastic energy against the INITIAL gear. Operates on the
    MOVING gear in place."""
    target_gear = kwargs.pop('target_gear', const.MESH_GEAR_MOVING)
    dev = device_mod.get_device(device)
    if free_vertices is None:
        free_vertices = np.ones(mesh.num_vertices, bool)
    free = np.zeros((mesh.num_vertices, 1), np.float32)
    free[np.asarray(free_vertices)] = 1.0
    groups = mesh.element_arrays(gear=const.MESH_GEAR_INITIAL)
    pos = mesh.vertices_w_offset(target_gear)
    pos_init = mesh.vertices_w_offset(const.MESH_GEAR_INITIAL)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    u = t(pos - pos_init)
    freej = t(free)
    nv = mesh.num_vertices
    Ke = []
    for g in groups:
        B, area2 = fem.shape_matrices(t(g['tripts']))
        Ke.append(fem.eng_element_stiffness(B, area2, t(g['multiplier']),
                                            t(g['poisson'])))
    Ke = torch.cat(Ke).contiguous()
    # the CG operator with no link (L = 0); the other sums in a fixed order
    tris = t(np.concatenate([mesh.triangles[g['start']:g['stop']]
                             for g in groups]), torch.int64)
    no_idx, no_bary = t(np.zeros((0, 3)), torch.int64), t(np.zeros((0, 3)))
    tables = fem.operator_tables(tris, nv, no_idx, no_bary, no_idx, no_bary)
    operator = fem.bind_elastic_operator(Ke, tables, t(np.zeros(0)), freej,
                                         1.0, 1.0)
    by_corner = fem.fixed_sum(tris, nv)

    def matvec(x):
        return operator(x * freej)

    b = -by_corner(torch.einsum('nij,nj->ni', Ke, fem.gather_uv(u, tris))
                   .reshape(-1, 2)) * freej
    diag = by_corner(torch.diagonal(Ke, dim1=1, dim2=2).reshape(-1, 2))
    diag = torch.where(freej > 0, diag, 1.0)
    dx, _, _ = fem.cg_solve(matvec, b, diag=diag,
                            tol=kwargs.get('tol', 1e-7), maxiter=2000)
    newpos = pos + (dx * freej).cpu().numpy().astype(np.float64)
    center = newpos.mean(axis=0, keepdims=True)
    mesh.set_vertices(newpos - center, target_gear, offset=center)
    return mesh


def relax_mesh_most_deformed(mesh, deform_quantile=0.75, iqr_factor=1.5,
                             **kwargs):
    """Relax the vertices of triangles whose deformation is an IQR outlier.
    Returns (mesh, relaxed?)."""
    d = mesh.svds_to_deform(gear1=const.MESH_GEAR_MOVING)
    q1, q3 = np.quantile(d, [0.25, 0.75])
    thresh = q3 + iqr_factor * (q3 - q1)
    bad_tris = d > max(thresh, 1e-3)
    if not bad_tris.any():
        return mesh, False
    free = np.zeros(mesh.num_vertices, bool)
    free[np.unique(mesh.triangles[bad_tris])] = True
    relax_mesh(mesh, free_vertices=free, **kwargs)
    return mesh, True


def coarse_mesh_SLM(slm, mesh_reduction_factor=0.25, **kwargs):
    """Relax a coarse surrogate system and map the result onto the fine
    meshes: each mesh's ``coarse_mesh`` at the MOVING gear, the links
    re-anchored on them, one ``optimize_elastic``, then each free fine
    mesh resampled through its coarse mesh's deformation
    (``transform_mesh``). With reduction 0 each mesh moves by one affine.
    Operates from the MOVING placement and writes MOVING; returns the max
    residue after it."""
    from feabas_tpu_torch.mesh import transform_mesh
    coarse = []
    for m in slm.meshes:
        cm = m.coarse_mesh(mesh_reduction_factor, gear=const.MESH_GEAR_MOVING)
        cm.locked = m.locked
        coarse.append(cm)
    cslm = SLM(coarse, dtype=slm.dtype, device=slm.device)
    for l in slm.active_links():
        cslm.add_link_from_coordinates(
            l.uids[0], l.uids[1],
            l.xy0(gear=const.MESH_GEAR_MOVING),
            l.xy1(gear=const.MESH_GEAR_MOVING), weight=l.weight(),
            gear=(const.MESH_GEAR_INITIAL, const.MESH_GEAR_INITIAL))
    cslm.optimize_elastic(
        stiffness_lambda=kwargs.get('stiffness_lambda', -0.35),
        crosslink_lambda=-1.0,
        tol=kwargs.get('tol', 1e-6),
        maxiter=kwargs.get('maxiter', None),
        residue_mode=kwargs.get('residue_mode', None),
        residue_len=kwargs.get('residue_len', 0))
    for m, cm in zip(slm.meshes, coarse):
        if m.locked:
            continue
        # the coarse INITIAL frame is the fine mesh's MOVING frame
        probe = m.copy()
        probe.set_vertices(m.vertices(const.MESH_GEAR_MOVING),
                           const.MESH_GEAR_FIXED,
                           offset=m.offset(const.MESH_GEAR_MOVING))
        out = transform_mesh(probe, cm,
                             gear=(const.MESH_GEAR_FIXED,
                                   const.MESH_GEAR_MOVING))
        mv = out.vertices_w_offset(const.MESH_GEAR_MOVING)
        center = mv.mean(axis=0, keepdims=True)
        m.set_vertices(mv - center, const.MESH_GEAR_MOVING, offset=center)
    r = slm.match_residues(gear=const.MESH_GEAR_MOVING)
    return float(r.max()) if r.size else 0.0
