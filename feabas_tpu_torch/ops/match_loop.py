"""Fused fine-round match loop: a tile pair's whole coarse-to-fine block
schedule on the device (counterpart of ``feabas_tpu/ops/match_loop.py``).

Every round (per-block affine from the current mesh positions -> batched
warp -> DoG -> FFT xcorr -> link targets -> Jacobi-PCG elastic solve ->
Huber reweight) chains on the device; the host plans the block lattices
once (matcher._fused_prep) and fetches one packed array per batch.

Where the JAX package ``vmap``s the schedule over tile pairs, every array
here carries an explicit leading PAIR axis P: pair p's vertices are rows
p*V .. p*V+V-1 of one flat (P*V, 2) system, so the FEM operators run once
for the whole batch and ``fem.cg_solve`` stops each pair on its own. The
JAX package chunks its FFTs at <= 128 blocks to dodge a TPU rfft2
precision change at larger batches; cuFFT and the CPU FFT have no such
change, so the whole (P*B) stack goes through one transform.
"""

import torch

from feabas_tpu_torch.ops import fem
from feabas_tpu_torch.ops.filters import masked_dog_filter
from feabas_tpu_torch.ops.warp import affine_warp_blocks_shifted
from feabas_tpu_torch.ops.xcorr import _peak_and_subpixel, mirror_confidence


def _flat_idx(idx, n):
    """Per-pair vertex ids (P, ...) -> rows of the flat (P*n, ...) array."""
    P = idx.shape[0]
    off = torch.arange(P, device=idx.device) * n
    return idx + off.reshape((P,) + (1,) * (idx.dim() - 1))


def _take(x, idx):
    """x (P, V, C), idx (P, ...) -> x[p, idx[p]] of shape (P, ..., C)."""
    return x.reshape(-1, x.shape[-1])[_flat_idx(idx, x.shape[1])]


def _mesh1_block_affines(pos, verts0, tri_idx):
    """Per-block affine from CURRENT (MOVING) world -> source (INITIAL)
    pixel coordinates, from the triangle holding each block centre:
    src = world @ A + b. Closed-form elementwise solve, as in the JAX
    package (no matmul at tile-scale absolute coordinates)."""
    Vm = _take(pos, tri_idx)           # (P, B, 3, 2) current
    Vi = _take(verts0, tri_idx)        # (P, B, 3, 2) source
    em1 = Vm[..., 1, :] - Vm[..., 0, :]
    em2 = Vm[..., 2, :] - Vm[..., 0, :]
    ei1 = Vi[..., 1, :] - Vi[..., 0, :]
    ei2 = Vi[..., 2, :] - Vi[..., 0, :]
    det = em1[..., 0] * em2[..., 1] - em1[..., 1] * em2[..., 0]
    det = torch.where(det.abs() > 1e-12, det, 1.0)
    A = torch.stack([
        torch.stack([(em2[..., 1] * ei1[..., 0] - em1[..., 1] * ei2[..., 0]) / det,
                     (em2[..., 1] * ei1[..., 1] - em1[..., 1] * ei2[..., 1]) / det],
                    dim=-1),
        torch.stack([(-em2[..., 0] * ei1[..., 0] + em1[..., 0] * ei2[..., 0]) / det,
                     (-em2[..., 0] * ei1[..., 1] + em1[..., 0] * ei2[..., 1]) / det],
                    dim=-1),
    ], dim=-2)                                         # (P, B, 2, 2)
    b = Vi[..., 0, :] - (Vm[..., 0, 0:1] * A[..., 0, :]
                         + Vm[..., 0, 1:2] * A[..., 1, :])
    return A, b


def _centered_bary(Pt, pts):
    """Barycentric coords of pts (..., 2) w.r.t. triangles Pt (..., 3, 2)
    by closed-form signed-area ratios."""
    q = pts - Pt[..., 0, :]
    e1 = Pt[..., 1, :] - Pt[..., 0, :]
    e2 = Pt[..., 2, :] - Pt[..., 0, :]
    det = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    det = torch.where(det.abs() > 1e-12, det, 1.0)
    b1 = (q[..., 0] * e2[..., 1] - q[..., 1] * e2[..., 0]) / det
    b2 = (e1[..., 0] * q[..., 1] - e1[..., 1] * q[..., 0]) / det
    return torch.stack([1.0 - b1 - b2, b1, b2], dim=-1)


def _bary_eval(pos, idx, bary):
    return (_take(pos, idx) * bary[..., None]).sum(dim=-2)


def _round_system(tris_flat, V, idx_a, bary_a, V0, idx0_a, valid,
                  n_valid=None):
    """What a round's solves share, built once a round on the device: the
    CG operator's tables over every pair's mesh1 (P*V vertices, P*E
    elements; each valid anchor a one-sided link, its side 0 weighing
    nothing; padding anchors, weighed 0 in every pass, in no row;
    ``n_valid`` the valid anchors of every pair, known on the host) and
    the fixed-order sums onto the anchors of mesh1 and of the locked
    mesh0."""
    P = idx_a.shape[0]
    flat_a = _flat_idx(idx_a, V).reshape(-1, 3)
    return {'tris': tris_flat,
            'tables': fem.operator_tables(
                tris_flat, P * V, None, None, flat_a, bary_a,
                keep=valid.reshape(-1) > 0, n_kept=n_valid),
            'by_anchor': fem.fixed_sum(flat_a, P * V),
            'by_anchor0': fem.fixed_sum(_flat_idx(idx0_a, V0), P * V0)}


def _solve_round(pos, u_shape, Ke, by_corner, dK, rs, idx_a, bary_a, w,
                 targets, lam_ratio, tol, maxiter, dK0, bary0_a):
    """One tangent elastic solve of every pair's mesh1 against its fixed
    link targets, with the trace-ratio lambda balance of the two-mesh
    system (the locked mesh0's stiffness diagonal and anchors enter the
    traces). ``by_corner`` / ``dK``: the fixed-order sum over the element
    corners and the stiffness diagonal; ``rs``: ``_round_system``'s. Each
    pair's lambda is folded into its element blocks, so the CG matvec is
    one launch of the operator ``fem.bind_elastic_operator`` binds, and
    every sum runs in a fixed order: the same bits every run."""
    P, V, _ = pos.shape
    w2 = (w ** 2)[..., None]
    dC = rs['by_anchor']((bary_a ** 2 * w2)[..., None].expand(-1, -1, -1, 2)
                         .reshape(-1, 2)).reshape(P, V, 2)
    dC0 = rs['by_anchor0']((bary0_a ** 2 * w2)[..., None]
                           .expand(-1, -1, -1, 2).reshape(-1, 2)
                           ).reshape(dK0.shape)
    tr_c = dC.sum(dim=(1, 2)) + dC0.sum(dim=(1, 2))
    tr_k = (torch.where(dC != 0, dK, 0.0).sum(dim=(1, 2))
            + torch.where(dC0 != 0, dK0, 0.0).sum(dim=(1, 2)))
    okl = (tr_c > 0) & (tr_k > 0)
    lam_s = torch.where(okl, lam_ratio * tr_c / torch.where(tr_k > 0, tr_k, 1.0),
                        1.0)
    E = Ke.shape[0] // P
    Ke_s = (Ke * lam_s.repeat_interleave(E)[:, None, None]).contiguous()
    operator = fem.bind_elastic_operator(
        Ke_s, rs['tables'], w.reshape(-1).contiguous(),
        torch.ones((P * V, 1), dtype=pos.dtype, device=pos.device), 1.0, 1.0)

    def matvec(x):
        return operator(x.reshape(-1, 2)).reshape(P, V, 2)

    u = pos - u_shape
    b = -by_corner(torch.einsum('nij,nj->ni', Ke_s,
                                fem.gather_uv(u.reshape(-1, 2), rs['tris']))
                   .reshape(-1, 2)).reshape(P, V, 2)
    r0 = (_bary_eval(pos, idx_a, bary_a) - targets) * w2
    b = b - rs['by_anchor']((bary_a[..., None] * r0[..., None, :])
                            .reshape(-1, 2)).reshape(P, V, 2)
    diag = dK * lam_s[:, None, None] + dC
    diag = torch.where(diag > 0, diag, 1.0)
    # chances: f32 CG stalls at its precision floor well before tol 1e-8
    dx, _n_it, _res = fem.cg_solve(matvec, b, diag=diag, tol=tol,
                                   maxiter=maxiter, chances=25)
    return pos + dx


def _avg_pool(img, k):
    """(P, H, W) -> (P, H//k, W//k) block means."""
    P = img.shape[0]
    H = (img.shape[1] // k) * k
    W = (img.shape[2] // k) * k
    return img[:, :H, :W].reshape(P, H // k, k, W // k, k).mean(dim=(2, 4))


def _coarse_seed(f0, f1, coarse, coarse_meta, dt):
    """In-program coarse seed: pooled whole-band xcorr of each pair.
    Returns (delta (P, 2), conf (P,))."""
    pool, cfy, cfx, csigma = coarse_meta
    p0 = _avg_pool(f0, pool)
    p1 = _avg_pool(f1, pool)
    dev = f0.device

    def vmask(shape, v):
        iy = torch.arange(shape[0], device=dev)[:, None]
        ix = torch.arange(shape[1], device=dev)[None, :]
        return ((iy < v[0]) & (ix < v[1])).to(torch.float32)[None]

    # one filter call per pair: the mask-leak scale (the input's peak-to-
    # peak) belongs to that pair's pooled band, as under the JAX vmap
    g0 = torch.cat([masked_dog_filter(p0[i:i + 1], csigma,
                                      mask=vmask(p0.shape[1:], coarse['v0'][i]))
                    for i in range(p0.shape[0])])
    g1 = torch.cat([masked_dog_filter(p1[i:i + 1], csigma,
                                      mask=vmask(p1.shape[1:], coarse['v1'][i]))
                    for i in range(p1.shape[0])])
    F0 = torch.fft.rfft2(g0, s=(cfy, cfx))
    F1 = torch.fft.rfft2(g1, s=(cfy, cfx))
    C = torch.fft.irfft2(torch.conj(F0) * F1, s=(cfy, cfx))
    dxc, dyc, _pk = _peak_and_subpixel(C, (cfy, cfx), False)
    dyc = dyc + (p0.shape[1] - p1.shape[1]) / 2
    dxc = dxc + (p0.shape[2] - p1.shape[2]) / 2
    dyc = dyc - torch.round(dyc / cfy) * cfy
    dxc = dxc - torch.round(dxc / cfx) * cfx
    conf = mirror_confidence(C, F0, F1, (cfy, cfx))
    d_full = torch.stack([dxc, dyc], dim=-1).to(dt) * pool
    return coarse['base'].to(dt) - d_full, conf.to(dt)


def fused_rounds_batched(src0, src1, pos1, verts0_1, shape1, tris1,
                         multiplier, poisson, rounds, meta, shape0, tris0,
                         multiplier0, poisson0, pos0, lam_ratio=0.35,
                         sigma=2.5, conf_thresh=0.3, huber_passes=2,
                         maxiter=600, coarse=None, coarse_meta=None,
                         env_norm=True, n_valid=None):
    """Run the full fine-match schedule of P same-shape tile pairs.

    Arguments are the JAX ``_fused_rounds_core``'s with a leading pair
    axis on every array (see ``state.fused_arrays``): src0/src1 (P, H, W)
    any dtype; pos1/verts0_1/shape1 (P, V, 2) in the solver dtype;
    tris1 (P, E, 3) int64; multiplier/poisson (P, E); rounds a tuple of
    dicts of (P, B, ...) tensors plus rlen (P,); meta the per-round
    statics (block_size, fft_y, fft_x, subpixel, translate_first, tol,
    warp_window_K); coarse a dict of (P, 2) tensors v0, v1, base; n_valid
    each round's count of valid anchors over every pair, where the host
    knows it (else each round reads it, one sync).
    Returns the packed (P, V + 3*B_last + 2, 2) array of the JAX package:
    [pos1_final; d_last; (conf_last, w_last); anchor bary[:, :2];
    [[coarse_conf, 0], [delta_x, delta_y]]].
    """
    f0 = src0.to(torch.float32)
    f1 = src1.to(torch.float32)
    P, V, _ = pos1.shape
    dt = pos1.dtype
    coarse_stats = torch.zeros((P, 2, 2), dtype=dt, device=pos1.device)
    if coarse_meta is not None:
        delta, conf_c = _coarse_seed(f0, f1, coarse, coarse_meta, dt)
        pos1 = pos1 + delta[:, None, :]
        coarse_stats[:, 0, 0] = conf_c
        coarse_stats[:, 1] = delta
    tris_flat = _flat_idx(tris1, V).reshape(-1, 3)
    B_mat, area2 = fem.shape_matrices(shape1.reshape(-1, 2)[tris_flat])
    Ke = fem.eng_element_stiffness(B_mat, area2, multiplier.reshape(-1),
                                   poisson.reshape(-1))
    # the locked mesh0 enters only the lambda-balance traces
    V0 = shape0.shape[1]
    tris0_flat = _flat_idx(tris0, V0).reshape(-1, 3)
    B0_mat, area2_0 = fem.shape_matrices(shape0.reshape(-1, 2)[tris0_flat])
    Ke0 = fem.eng_element_stiffness(B0_mat, area2_0, multiplier0.reshape(-1),
                                    poisson0.reshape(-1))
    dK0 = fem.fixed_sum(tris0_flat, P * V0)(
        torch.diagonal(Ke0, dim1=1, dim2=2).reshape(-1, 2)).reshape(P, V0, 2)
    by_corner = fem.fixed_sum(tris_flat, P * V)
    dK = by_corner(torch.diagonal(Ke, dim1=1, dim2=2).reshape(-1, 2)
                   ).reshape(P, V, 2)
    out = None
    if n_valid is None:
        n_valid = (None,) * len(rounds)
    for rd, (bs, fy, fx, subpixel, translate_first, tol, K), n_v in zip(
            rounds, meta, n_valid):
        A1, b1 = _mesh1_block_affines(pos1.to(torch.float32),
                                      verts0_1.to(torch.float32), rd['tri_idx'])
        blocks0 = affine_warp_blocks_shifted(f0, rd['origins'], rd['A0'],
                                             rd['b0'], bs, bs, K)
        blocks1 = affine_warp_blocks_shifted(f1, rd['origins'], A1, b1,
                                             bs, bs, K)
        Bn = blocks0.shape[1]
        g0 = masked_dog_filter(blocks0.reshape(-1, bs, bs), sigma)
        g1 = masked_dog_filter(blocks1.reshape(-1, bs, bs), sigma)
        F0 = torch.fft.rfft2(g0, s=(fy, fx))
        F1 = torch.fft.rfft2(g1, s=(fy, fx))
        Fc = torch.conj(F0) * F1
        C = torch.fft.irfft2(Fc, s=(fy, fx))
        # overlap-envelope normalization of the final round's peaks, for
        # blocks whose whole source read window is interior (host flag
        # env_ok), by the shared analytic full-block envelope clamped at
        # 0.5 relative overlap; only blocks >= 64 px
        if bool(env_norm) and bool(subpixel) and bs >= 64:
            Mk = torch.fft.rfft2(torch.ones((1, bs, bs), dtype=torch.float32,
                                            device=C.device), s=(fy, fx))
            Nc_env = torch.conj(Mk) * Mk
            E = torch.fft.irfft2(Nc_env, s=(fy, fx))
            env_div = torch.clamp(E / torch.clamp(E.max(), min=1e-6), min=0.5)
            okc = rd['env_ok'].reshape(-1)[:, None, None]
            C_pk = torch.where(okc > 0, C / env_div, C)
        else:
            C_pk, Nc_env = C, None
        dx, dy, _peak = _peak_and_subpixel(C_pk, (fy, fx), subpixel, Fc=Fc,
                                           Nc=Nc_env)
        # the confidence ratio stays on the RAW surfaces
        conf = mirror_confidence(C, F0, F1, (fy, fx))
        dy = dy - torch.round(dy / fy) * fy
        dx = dx - torch.round(dx / fx) * fx
        d = torch.stack([dx, dy], dim=-1).to(dt).reshape(P, Bn, 2)
        conf = conf.reshape(P, Bn)
        w0 = torch.where((conf >= conf_thresh) & (rd['valid'] > 0),
                         conf, 0.0).to(dt)
        # xcorr convention: block1's content at c matches block0's at c-d
        targets = rd['centers'] - d
        idx_a = rd['anchor_idx']
        # anchors: mesh1 material points at the block centres AT
        # MEASUREMENT TIME (barycentrics against the current positions)
        bary_a = _centered_bary(_take(pos1, idx_a), rd['centers'])
        bary0_a = _centered_bary(_take(pos0, rd['anchor_idx0']), targets)
        if translate_first:
            p1 = _bary_eval(pos1, idx_a, bary_a)
            w02 = (w0 ** 2)[..., None]
            wsum = torch.clamp(w02.sum(dim=1), min=1e-12)
            pos1 = pos1 + (((targets - p1) * w02).sum(dim=1) / wsum)[:, None, :]
        w = w0
        rs = _round_system(tris_flat, V, idx_a, bary_a, V0, rd['anchor_idx0'],
                           rd['valid'], n_v)
        for _p in range(huber_passes + 1):
            pos1 = _solve_round(pos1, shape1, Ke, by_corner, dK, rs, idx_a,
                                bary_a, w, targets, lam_ratio, tol, maxiter,
                                dK0, bary0_a)
            if _p < huber_passes:
                res = torch.linalg.norm(_bary_eval(pos1, idx_a, bary_a)
                                        - targets, dim=-1)
                f = torch.clamp(rd['rlen'][:, None].to(dt)
                                / torch.clamp(res, min=1e-9), max=1.0)
                w = w0 * f
        out = (d, conf.to(dt), w, bary_a)
    d_last, conf_last, w_last, bary_last = out
    return torch.cat([pos1, d_last, torch.stack([conf_last, w_last], dim=-1),
                      bary_last[..., :2], coarse_stats], dim=1)
