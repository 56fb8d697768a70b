"""Window solve over a z-stack of sections on one torch device
(counterpart of ``feabas_tpu/parallel/window.py``).

Serial-section alignment couples consecutive sections with crosslinks
while each section carries its own stiffness: a block-tridiagonal system
along z. ``stack_solve`` relaxes one window of S sections as a single
system in displacement form: per-section LOCAL rest coordinates, the start
displacement u = pos - verts0 and the per-link rest residual, so f32
device math keeps sub-0.001 px resolution at any world extent; world
positions reassemble on the host in f64 (``stack_positions``). Sections
may have different topologies: they pad to the window's pow2-bucketed max
(V, T) with inert elements.

The stack flattens to one (S*V, 2) vertex array with global element and
link indices. Uniform lattice stacks run the 9-plane stencil matvec over
the (S, ny, nx) lattice; the crosslink transpose runs as the link-transpose
gather (``build_link_transpose``) when it is given. Every other sum onto
vertices runs in a fixed order (``fem.fixed_sum``): no atomics, so a solve
on the card gives the same bits every run. CG is preconditioned by Jacobi
plus an exact (S, S) coarse solve over per-section translations.

The sharded multi-device forms (``shard_stack_system``, ``_put_global``,
``initialize_multihost``, ``multihost_window_solve``,
``global_stack_mesh``, ``gather_stack_result``) are not ported yet; at one
device ``pad_stack_sections`` is the identity.
"""

import numpy as np
import torch

from feabas_tpu_torch import constant as const
from feabas_tpu_torch.ops import fem


def _pow2(n, lo=8):
    return max(lo, 1 << int(max(n, 1) - 1).bit_length())


def build_stack_system(meshes, links_per_pair, pow2_bucket=True):
    """Pack S meshes + neighbour links into padded batched numpy arrays
    (INITIAL shape gear, MOVING start gear). ``links_per_pair``: S-1 dicts
    of idx0, bary0, idx1, bary1, weight -- section-local vertex indices
    linking z to z+1."""
    return _build_system(meshes, links_per_pair,
                         shape_gear=const.MESH_GEAR_INITIAL,
                         start_gear=const.MESH_GEAR_MOVING,
                         pow2_bucket=pow2_bucket)


def _build_system(meshes, links_per_pair, shape_gear, start_gear,
                  pow2_bucket=True):
    S = len(meshes)
    nvs = [m.num_vertices for m in meshes]
    nts = [m.triangles.shape[0] for m in meshes]
    # uniform stacks carry no padding; ragged ones pad to pow2 buckets
    ragged = (len(set(nvs)) > 1 or len(set(nts)) > 1
              or any(not np.array_equal(m.triangles, meshes[0].triangles)
                     for m in meshes[1:]))
    V = _pow2(max(nvs)) if (pow2_bucket and ragged) else max(nvs)
    T = _pow2(max(nts)) if (pow2_bucket and ragged) else max(nts)
    tris = np.zeros((S, T, 3), np.int32)
    verts0_local = np.zeros((S, V, 2), np.float64)
    u = np.zeros((S, V, 2), np.float64)
    mult = np.zeros((S, T), np.float64)
    poisson = np.zeros((S, T), np.float64)
    free = np.zeros((S, V, 1), np.float32)
    verts0_host = []
    for k, m in enumerate(meshes):
        nv, nt = nvs[k], nts[k]
        v0 = m.vertices_w_offset(shape_gear)
        pos = m.vertices_w_offset(start_gear)
        verts0_host.append(v0)
        verts0_local[k, :nv] = v0 - v0.mean(axis=0)
        # padding vertices sit at the section center (valid coords)
        u[k, :nv] = pos - v0
        tr = m.triangles
        tris[k, :nt] = tr
        # pad with inert copies of element 0 (multiplier 0 -> Ke = 0)
        tris[k, nt:] = tr[0]
        groups = m.element_arrays(gear=shape_gear)
        mult[k, :nt] = np.concatenate([g['multiplier'] for g in groups])
        poisson[k, :nt] = np.concatenate([g['poisson'] for g in groups])
        if not m.locked:
            free[k, :nv, 0] = 1.0
    # links: pad per pair to a common (pow2) length
    L = max((l['weight'].shape[0] for l in links_per_pair), default=0)
    L = _pow2(L) if pow2_bucket else max(L, 1)
    P = max(S - 1, 1)
    idx0 = np.zeros((P, L, 3), np.int32)
    bary0 = np.zeros((P, L, 3), np.float32)
    idx1 = np.zeros((P, L, 3), np.int32)
    bary1 = np.zeros((P, L, 3), np.float32)
    weight = np.zeros((P, L), np.float32)
    r_rest = np.zeros((P, L, 2), np.float64)
    for k, l in enumerate(links_per_pair):
        n = l['weight'].shape[0]
        idx0[k, :n] = l['idx0']
        bary0[k, :n] = l['bary0']
        idx1[k, :n] = l['idx1']
        bary1[k, :n] = l['bary1']
        weight[k, :n] = l['weight']
        if n:
            p0r = (verts0_host[k][np.asarray(l['idx0'])]
                   * np.asarray(l['bary0'], np.float64)[..., None]).sum(1)
            p1r = (verts0_host[k + 1][np.asarray(l['idx1'])]
                   * np.asarray(l['bary1'], np.float64)[..., None]).sum(1)
            r_rest[k, :n] = p1r - p0r
    system = {
        # uniform stacks share ONE (T, 3) triangle table
        'tris': tris[0] if not ragged else tris,
        'verts0': verts0_local.astype(np.float32),
        'u': u.astype(np.float32),
        'r_rest': r_rest.astype(np.float32),
        'multiplier': mult.astype(np.float32),
        'poisson': poisson.astype(np.float32),
        'links': (idx0, bary0, idx1, bary1, weight),
        'free': free,
        'verts0_host': verts0_host,
        'num_vertices': nvs,
    }
    if not ragged:
        _lattice_pack(system, meshes[0], shape_gear)
    return system


def _lattice_pack(system, mesh0, shape_gear):
    """Re-index a uniform stack onto its vertex lattice when the shared
    topology embeds (``fem.lattice_embedding``): vertices pack in
    row-major (ny, nx) cell order, unoccupied cells become inert padding,
    and ``grid_shape`` + the stencil assembly table ``sten`` are added.
    No-op when the mesh is not a lattice."""
    emb = fem.lattice_embedding(
        mesh0.vertices_w_offset(shape_gear), np.asarray(system['tris']))
    if emb is None:
        return
    cell_of, (ny, nx) = emb
    Vg = ny * nx
    S = system['u'].shape[0]
    nv = cell_of.shape[0]

    def pack_rows(a, fill=0.0):
        out = np.full((S, Vg) + a.shape[2:], fill, a.dtype)
        out[:, cell_of] = a[:, :nv]
        return out

    system['verts0'] = pack_rows(system['verts0'])
    system['u'] = pack_rows(system['u'])
    system['free'] = pack_rows(system['free'])
    system['tris'] = cell_of[np.asarray(system['tris'])].astype(np.int32)
    idx0, bary0, idx1, bary1, weight = system['links']
    system['links'] = (cell_of[idx0].astype(np.int32), bary0,
                       cell_of[idx1].astype(np.int32), bary1, weight)
    vh = []
    for v0 in system['verts0_host']:
        out = np.zeros((Vg, 2), v0.dtype)
        out[cell_of] = v0[:nv]
        vh.append(out)
    system['verts0_host'] = vh
    system['num_vertices'] = [Vg] * S
    # real-vertex mask: rigid modes and residue passes skip holes
    rm = np.zeros(Vg, bool)
    rm[cell_of] = True
    system['real_mask'] = rm
    system['vertex_map'] = cell_of          # original vertex -> cell
    system['grid_shape'] = (ny, nx)
    system['sten'] = fem.build_stencil_assembly(
        np.asarray(system['tris']), nx, Vg)


def stack_rigid_modes(system):
    """Orthonormal rigid modes (tx, ty, rotation about the component
    centroid) of every fully-free chain component of a stacked system, as
    (K, S, V, 2), or None when every component holds a locked section.
    Mode support excludes padding vertices and lattice holes."""
    from feabas_tpu_torch.optimizer import rigid_modes_flat
    free = np.asarray(system['free'])                   # (S, V, 1)
    S, V = free.shape[0], free.shape[1]
    weight = np.asarray(system['links'][4])             # (S-1, L)
    nvs = system['num_vertices']
    verts0_host = system['verts0_host']
    # chain components: cut at pairs with no active links
    comp = np.zeros(S, np.int64)
    for k in range(1, S):
        comp[k] = comp[k - 1] + (0 if (k - 1 < weight.shape[0]
                                       and (weight[k - 1] > 0).any())
                                 else 1)
    sec_free = free.max(axis=(1, 2)) > 0
    slot = np.arange(S * V).reshape(S, V)
    rmask = system.get('real_mask')
    comps = []
    for lbl in np.unique(comp):
        sel = np.nonzero(comp == lbl)[0]
        if not sec_free[sel].all():
            continue
        if rmask is None:
            rows = np.concatenate([slot[s, :nvs[s]] for s in sel])
            q = np.concatenate([verts0_host[s][:nvs[s]] for s in sel])
        else:
            rows = np.concatenate([slot[s][rmask] for s in sel])
            q = np.concatenate([verts0_host[s][rmask] for s in sel])
        comps.append((rows, q))
    modes = rigid_modes_flat(S * V, comps)
    return None if modes is None else modes.reshape(-1, S, V, 2)


def build_link_transpose(links, S, V):
    """Host transpose tables of the crosslink scatter (topology-static,
    weight-independent): per section, each touched vertex gathers its few
    contributions from the flattened per-iteration contribution array
    [side0 | side1 rolled to its section | one zero row] and is placed with
    a unique-index add. Returns (tv (S, P) int32 target vertices, inc
    (S, P, D) int32 rows into the (6L+1)-row array), or None."""
    idx0 = np.asarray(links[0])
    bar0 = np.asarray(links[1])
    idx1 = np.asarray(links[2])
    bar1 = np.asarray(links[3])
    L = idx0.shape[1]
    if idx0.shape[0] != S:                       # (S-1)-slot layout
        pad = np.zeros((1, L, 3), idx0.dtype)
        padb = np.zeros((1, L, 3), bar0.dtype)
        idx0 = np.concatenate([idx0, pad], axis=0)
        idx1 = np.concatenate([idx1, pad], axis=0)
        bar0 = np.concatenate([bar0, padb], axis=0)
        bar1 = np.concatenate([bar1, padb], axis=0)
    zero_row = 6 * L
    ent_v, ent_f, ent_s = [], [], []
    for z in range(S):
        # entries with a zero barycentric weight contribute nothing in any
        # pass: prune them (the inert padded slots among them)
        m0 = (bar0[z].ravel() != 0)
        ent_v.append(idx0[z].ravel()[m0])
        ent_f.append(np.arange(3 * L)[m0])
        ent_s.append(np.full(int(m0.sum()), z))
        zp = (z - 1) % S                         # side1 rolls +1
        m1 = (bar1[zp].ravel() != 0)
        ent_v.append(idx1[zp].ravel()[m1])
        ent_f.append(3 * L + np.arange(3 * L)[m1])
        ent_s.append(np.full(int(m1.sum()), z))
    ev = np.concatenate(ent_v)
    ef = np.concatenate(ent_f)
    es = np.concatenate(ent_s)
    if ev.size == 0:
        return None
    key = es.astype(np.int64) * V + ev
    order = np.argsort(key, kind='stable')
    key_s, ef_s = key[order], ef[order]
    uniq, starts = np.unique(key_s, return_index=True)
    counts = np.diff(np.append(starts, key_s.size))
    D = 1 << int(counts.max() - 1).bit_length()
    P_real = max(int(np.bincount(uniq // V, minlength=S).max()), 1)
    # pow2 bucket capped at V: pad slots each claim a distinct unused vertex
    P = min(1 << int(P_real - 1).bit_length(), V)
    tv = np.zeros((S, P), np.int32)
    inc = np.full((S, P, D), zero_row, np.int32)
    used = np.zeros((S, V), bool)
    used[uniq // V, uniq % V] = True
    slot = np.zeros(S, np.int64)
    for k in range(uniq.size):
        z, v = int(uniq[k] // V), int(uniq[k] % V)
        p = slot[z]
        tv[z, p] = v
        c = counts[k]
        inc[z, p, :c] = ef_s[starts[k]:starts[k] + c]
        slot[z] += 1
    for z in range(S):
        n_pad = P - slot[z]
        if n_pad:
            free_ids = np.nonzero(~used[z])[0]
            if free_ids.size < n_pad:            # degenerate tiny mesh
                return None
            tv[z, slot[z]:] = free_ids[:n_pad]
    return tv, inc


def _pad_links_to_sections(links, S):
    """Link arrays on a full-S leading axis (slot z couples sections z and
    z+1; the last slot is inert, weight 0): (S-1)-slot inputs gain one zero
    row, full-S inputs pass through."""
    if links[0].shape[0] == S:
        return tuple(links)
    return tuple(torch.cat([a, torch.zeros_like(a[:1])], dim=0)
                 for a in links)


class _StackOps:
    """The stacked operators on one flattened (S*V, 2) vertex array: global
    element, incidence and link tables built once per solve."""

    def __init__(self, Ke, tris, links, free, S, V, inc=None, imask=None,
                 C=None, grid_shape=None, linc=None):
        dev = free.device
        ar = torch.arange(S, device=dev)
        self.S, self.V = S, V
        self.Ke = Ke                                   # (S*T, 6, 6)
        self.free = free.reshape(S * V, 1)
        T = Ke.shape[0] // S
        if tris.dim() == 2:
            tris = tris[None].expand(S, -1, -1)
        self.tris = (tris.long() + (ar * V)[:, None, None]).reshape(-1, 3)
        self.inc = self.imask = None
        if inc is not None:
            if inc.dim() == 2:
                inc = inc[None].expand(S, -1, -1)
                imask = imask[None].expand(S, -1, -1)
            self.inc = (inc.long() + (ar * 3 * T)[:, None, None]).reshape(S * V, -1)
            self.imask = imask.reshape(S * V, -1)
        self.C, self.grid_shape = C, grid_shape
        idx0, bary0, idx1, bary1, weight = _pad_links_to_sections(links, S)
        L = weight.shape[1]
        self.L = L
        self.idx0 = (idx0.long() + (ar * V)[:, None, None]).reshape(-1, 3)
        self.idx1 = (idx1.long()
                     + (((ar + 1) % S) * V)[:, None, None]).reshape(-1, 3)
        self.bary0 = bary0.reshape(-1, 3)
        self.bary1 = bary1.reshape(-1, 3)
        self.weight = weight.reshape(-1)
        self.linc = None
        if linc is not None:
            tv, incl = linc
            rows = 6 * L + 1
            self.linc = ((tv.long() + (ar * V)[:, None]).reshape(-1),
                         (incl.long() + (ar * rows)[:, None, None])
                         .reshape(S * tv.shape[1], -1))
        # the fixed-order sums of the forms without a gather table
        self.by_corner = None
        if C is None and self.inc is None:
            self.by_corner = fem.fixed_sum(self.tris, S * V)
        self.by_link = None
        if self.linc is None:
            self.by_link = fem.link_sum(self.idx0, self.idx1, S * V)

    def stiffness(self, x):
        """K x over every section, (S*V, 2)."""
        if self.C is not None:
            ny, nx = self.grid_shape
            return fem.stiffness_matvec_stencil(
                x.reshape(self.S, self.V, 2), self.C, ny, nx).reshape(-1, 2)
        if self.inc is not None:
            return fem.stiffness_matvec_gather(x, self.Ke, self.tris,
                                               self.inc, self.imask)
        y = torch.einsum('nij,nj->ni', self.Ke, fem.gather_uv(x, self.tris))
        return self.by_corner(y.reshape(-1, 2))

    def stiffness_diag(self):
        if self.C is not None:
            return fem.stencil_diag(self.C, self.V).reshape(-1, 2)
        d = torch.diagonal(self.Ke, dim1=1, dim2=2)
        if self.inc is not None:
            return fem.gather_scatter_uv(d, self.inc, self.imask)
        return self.by_corner(d.reshape(-1, 2))

    def push(self, c0, c1):
        """Per link-point rows (S*L, 3, C) of side 0 (``c0``) and side 1
        (``c1``) summed onto their vertices, (S*V, C): through the link
        transpose gather and its unique-index add when it is given, else a
        fixed-order sum; no atomics either way."""
        if self.linc is None:
            return self.by_link(c0, c1)
        S, L, C = self.S, self.L, c0.shape[-1]
        cc = torch.cat([c0.reshape(S, 3 * L, C),
                        torch.roll(c1.reshape(S, 3 * L, C), 1, dims=0),
                        c0.new_zeros(S, 1, C)], dim=1).reshape(-1, C)
        tv, incl = self.linc
        # tv holds each vertex once (build_link_transpose): one value lands
        # on each zero, so the add is exact whatever its order
        return c0.new_zeros(self.S * self.V, C).index_add_(
            0, tv, cc[incl].sum(dim=1))

    def link_rows(self, r):
        """C^T r for per-link rows r (S*L, 2)."""
        return fem.link_transpose(self.push, self.bary0, self.bary1, r)

    def crosslink(self, x):
        """C^T W C x: residuals (p1 - p0) w^2 pushed back to both sides."""
        r = (fem.link_eval(x, self.idx1, self.bary1)
             - fem.link_eval(x, self.idx0, self.bary0)) \
            * (self.weight ** 2)[:, None]
        return self.link_rows(r)

    def crosslink_diag(self):
        """Diagonal of C^T W C (exact for real links; Jacobi otherwise)."""
        return fem.link_diag(self.push, self.bary0, self.bary1, self.weight)


def _stack_matvec(x, ops, lam_s):
    """A x = lam_s K x + C^T W C x over the free vertices of the flattened
    stack (the counterpart's ``_stack_matvec``)."""
    x = x * ops.free
    return (ops.stiffness(x) * lam_s + ops.crosslink(x)) * ops.free


def stack_solve(verts0, u, tris, multiplier, poisson, links, r_rest, free,
                lam_s=1.0, tol=1e-7, maxiter=500, inc=None, imask=None,
                modes=None, lam_ratio=None, grid_shape=None, linc=None,
                sten=None):
    """One window relaxation in displacement form; tensors on one device.

    Minimizes lam_s/2 u'Ku + 1/2 |W C p|^2 over the free vertices
    (``free`` (S, V, 1)). With ``lam_ratio``, lam_s is the stiffness /
    crosslink diagonal trace ratio times lam_ratio. With ``grid_shape``
    (lattice-packed uniform stacks) the FEM matvec is the 9-plane stencil,
    assembled through ``sten`` (built from ``tris`` when not given).
    ``modes`` (K, S, V, 2) are projected out of the update. Returns
    (new_u (S, V, 2), iterations, residual norm).
    """
    from feabas_tpu_torch.optimizer import _mode_projector
    S, V = u.shape[:2]
    dt = u.dtype
    dev = u.device
    shared = tris.dim() == 2
    if inc is not None and (inc.dim() == 2) != shared:
        raise ValueError(f'incidence table rank {inc.dim()} does not match '
                         f'{"shared" if shared else "per-section"} tris')
    if shared:
        tp = verts0[:, tris.long()]
    else:
        tp = verts0[torch.arange(S, device=dev)[:, None, None], tris.long()]
    T = tp.shape[1]
    B, area2 = fem.shape_matrices(tp.reshape(S * T, 3, 2).to(dt))
    Ke = fem.eng_element_stiffness(B, area2, multiplier.reshape(-1).to(dt),
                                   poisson.reshape(-1).to(dt))
    C = None
    if grid_shape is not None and shared:
        ny, nx = grid_shape
        if ny * nx != V:
            raise ValueError(f'grid_shape {grid_shape} does not tile '
                             f'V={V} vertices')
        if sten is None:
            sten = torch.as_tensor(fem.build_stencil_assembly(
                tris.cpu().numpy(), nx, V), device=dev)
        C = fem.stencil_assemble_gather(Ke.reshape(S, T, 6, 6), sten)
    ops = _StackOps(Ke, tris, tuple(a.to(dt) if a.is_floating_point() else a
                                    for a in links),
                    free.to(dt), S, V, inc=inc,
                    imask=None if imask is None else imask.to(dt), C=C,
                    grid_shape=grid_shape if C is not None else None,
                    linc=linc)
    project = _mode_projector(None if modes is None
                              else modes.to(dt).reshape(-1, S * V, 2))
    r_rest = _pad_links_to_sections((r_rest.to(dt),), S)[0].reshape(-1, 2)
    u_flat = u.reshape(S * V, 2)
    dK = ops.stiffness_diag()
    dC = ops.crosslink_diag()
    if lam_ratio is not None:
        tr_c = dC.sum()
        tr_k = torch.where(dC != 0, dK, 0.0).sum()
        ok = (tr_c > 0) & (tr_k > 0)
        lam_s = torch.where(ok, lam_ratio * tr_c
                            / torch.where(tr_k > 0, tr_k, 1.0), 1.0).to(dt)
    # rhs = -(lam_s K u + C^T W r(pos)), r(pos) = r_rest + (U1 - U0)
    b = -ops.stiffness(u_flat) * lam_s
    r0 = (r_rest + fem.link_eval(u_flat, ops.idx1, ops.bary1)
          - fem.link_eval(u_flat, ops.idx0, ops.bary0)) \
        * (ops.weight ** 2)[:, None]
    b = (b - ops.link_rows(r0)) * ops.free
    diag = torch.where(ops.free > 0, dK * lam_s + dC, 1.0)

    # two-level preconditioner: the stiffness annihilates per-section
    # translations, so the chain's slow modes live in an (S, S)
    # tridiagonal coarse space built from the crosslink weights alone --
    # solved exactly (f32 inverse, TF32 off) and added to Jacobi
    ok = diag > 1e-12
    minv = torch.where(ok, 1.0 / torch.where(ok, diag, 1.0), 1.0)
    freed = ops.free.reshape(S, V).amax(dim=1)             # (S,)
    Wp = (ops.weight.reshape(S, -1) ** 2).sum(dim=1)[:-1]  # (S-1,)
    cdiag = torch.zeros(S, dtype=dt, device=dev)
    cdiag[:-1] += Wp
    cdiag[1:] += Wp
    Acm = torch.diag(cdiag) + torch.diag(-Wp, 1) + torch.diag(-Wp, -1)
    Acm = torch.where(freed[:, None] * freed[None, :] > 0, Acm, 0.0)
    reg = torch.clamp(cdiag.max(), min=1.0)
    Acm = Acm + torch.diag(torch.where(freed > 0, 1e-6 * reg, reg))
    Acinv = torch.linalg.inv(Acm)
    free_s = ops.free.reshape(S, V, 1)

    def precond(r):
        cc = (Acinv @ r.reshape(S, V, 2).sum(dim=1)) * freed[:, None]
        return project(r * minv + (cc[:, None, :] * free_s).reshape(-1, 2))

    def matvec(x):
        return project(_stack_matvec(project(x), ops, lam_s))

    dx, n_it, res = fem.cg_solve(matvec, project(b), diag=diag, tol=tol,
                                 maxiter=maxiter, precond=precond)
    return u + (project(dx) * ops.free).reshape(S, V, 2), n_it, res


def pad_stack_sections(system, multiple):
    """Append inert sections (repeated geometry, multiplier 0, no free
    DOFs, zero-weight links) so the section count divides ``multiple``;
    the identity at ``multiple`` 1."""
    S = system['u'].shape[0]
    pad = (-S) % int(multiple)
    if pad == 0:
        return system
    out = dict(system)

    def rep_last(a):
        a = np.asarray(a)
        return np.concatenate([a] + [a[-1:]] * pad, axis=0)

    def zeros_like_rows(a):
        a = np.asarray(a)
        return np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)

    out['verts0'] = rep_last(system['verts0'])
    out['u'] = rep_last(system['u'])
    out['poisson'] = rep_last(system['poisson'])
    out['multiplier'] = zeros_like_rows(system['multiplier'])
    out['free'] = zeros_like_rows(system['free'])
    if np.asarray(system['tris']).ndim == 3:
        out['tris'] = rep_last(system['tris'])
    out['links'] = tuple(zeros_like_rows(a) for a in system['links'])
    out['r_rest'] = zeros_like_rows(system['r_rest'])
    out['num_vertices'] = list(system['num_vertices']) + [0] * pad
    out['verts0_host'] = (list(system['verts0_host'])
                          + [system['verts0_host'][-1]] * pad)
    out.pop('linc', None)     # S-aligned; rebuild after padding
    return out


def slm_window_to_stack(slm, shape_gear=None):
    """Pack an SLM window into the stacked z-chain form, or None when it is
    not one (fewer than 2 meshes, nonlinear materials or stiffness curves,
    or a link between non-neighbouring sections). Built at ``shape_gear``
    (default FIXED)."""
    shape_gear = const.MESH_GEAR_FIXED if shape_gear is None else shape_gear
    meshes = slm.meshes
    if len(meshes) < 2 or not slm.is_linear:
        return None
    for m in meshes:
        for g in m.element_arrays(gear=shape_gear):
            if g['knots'] is not None:
                return None
    uid2idx = {m.uid: i for i, m in enumerate(meshes)}
    S = len(meshes)
    pair_links = {}
    for l in slm.active_links():
        i0, i1 = uid2idx[l.uids[0]], uid2idx[l.uids[1]]
        if abs(i0 - i1) != 1:
            return None  # long-range anchor: not a pure z-chain
        k = min(i0, i1)
        tid0, bary0 = l._tid0, l._bary0
        tid1, bary1 = l._tid1, l._bary1
        if i0 > i1:
            tid0, bary0, tid1, bary1 = tid1, bary1, tid0, bary0
            m_lo, m_hi = meshes[i1], meshes[i0]
        else:
            m_lo, m_hi = meshes[i0], meshes[i1]
        ent = pair_links.setdefault(k, {'idx0': [], 'bary0': [], 'idx1': [],
                                        'bary1': [], 'weight': []})
        ent['idx0'].append(m_lo.triangles[tid0])
        ent['bary0'].append(bary0)
        ent['idx1'].append(m_hi.triangles[tid1])
        ent['bary1'].append(bary1)
        ent['weight'].append(l.weight())
    links_per_pair = []
    for k in range(S - 1):
        ent = pair_links.get(k)
        if ent is None:
            links_per_pair.append({
                'idx0': np.zeros((0, 3), np.int32),
                'bary0': np.zeros((0, 3), np.float32),
                'idx1': np.zeros((0, 3), np.int32),
                'bary1': np.zeros((0, 3), np.float32),
                'weight': np.zeros(0, np.float32)})
        else:
            links_per_pair.append(
                {kk: np.concatenate(vv) for kk, vv in ent.items()})
    return _build_system(meshes, links_per_pair, shape_gear=shape_gear,
                         start_gear=const.MESH_GEAR_MOVING)


def stack_positions(system, u):
    """World-frame f64 positions per section from a solved displacement
    stack: list of (V_i, 2) arrays in each mesh's own vertex order."""
    vm = system.get('vertex_map')
    out = []
    for k, v0 in enumerate(system['verts0_host']):
        nv = system['num_vertices'][k]
        pos = v0[:nv] + np.asarray(u[k, :nv], np.float64)
        if vm is not None and nv:
            pos = pos[vm]
        out.append(pos)
    return out
