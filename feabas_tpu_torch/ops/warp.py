"""Image warping on the device: bilinear sampling and per-block affine
warps (counterpart of ``feabas_tpu/ops/warp.py``).

Block warps take a leading PAIR axis where the matcher batches tile
pairs: ``img`` (P, H, W) with origins (P, B, 2), A (P, B, 2, 2) and
b (P, B, 2); an (H, W) image with (B, ...) tables is the one-pair form.
"""

import numpy as np
import torch


def _bilinear_weights(xs, ys, W, H):
    x0c = torch.clamp(torch.floor(xs), 0, W - 2)
    y0c = torch.clamp(torch.floor(ys), 0, H - 2)
    # fractions vs the CLAMPED base so xs == W-1 reads img[..., W-1]
    # (fx=1 there), not img[..., W-2]
    fx = xs - x0c
    fy = ys - y0c
    valid = (xs >= 0) & (ys >= 0) & (xs <= W - 1) & (ys <= H - 1)
    return x0c.to(torch.int64), y0c.to(torch.int64), fx, fy, valid


def bilinear_sample(img, xs, ys, fillval=0.0):
    """Sample img (H, W) at float coords; out-of-range -> fillval."""
    H, W = img.shape
    x0, y0, fx, fy, valid = _bilinear_weights(xs, ys, W, H)
    flat = img.reshape(-1)
    i00 = y0 * W + x0
    Ia = flat[i00]
    Ib = flat[i00 + 1]
    Ic = flat[i00 + W]
    Id = flat[i00 + W + 1]
    out = (Ia * (1 - fx) * (1 - fy) + Ib * fx * (1 - fy)
           + Ic * (1 - fx) * fy + Id * fx * fy)
    return torch.where(valid, out, torch.as_tensor(fillval, dtype=out.dtype,
                                                   device=out.device))


def pack_u8_quads(src):
    """Pack each pixel's 2x2 bilinear neighbourhood of a uint8 image
    (..., H, W) into one int32 word: byte 0 = img[y, x], 1 = img[y, x+1],
    2 = img[y+1, x], 3 = img[y+1, x+1] (edge-clamped). The bit pattern is
    that of the JAX package's uint32 words; int32 holds it because torch
    shifts signed words."""
    s = src.to(torch.int32)
    sr = torch.cat([s[..., :, 1:], s[..., :, -1:]], dim=-1)
    sd = torch.cat([s[..., 1:, :], s[..., -1:, :]], dim=-2)
    sdr = torch.cat([sd[..., :, 1:], sd[..., :, -1:]], dim=-1)
    return s | (sr << 8) | (sd << 16) | (sdr << 24)


def bilinear_sample_packed(packed, xs, ys, fillval=0.0, slot=None):
    """Bilinear sample from a ``pack_u8_quads`` image (H, W): one gather
    per pixel, neighbours unpacked with bit ops. With a packed stack
    (N, H, W), ``slot`` (C,) picks the image for each leading row of
    xs/ys (C, ...)."""
    H, W = packed.shape[-2:]
    x0, y0, fx, fy, valid = _bilinear_weights(xs, ys, W, H)
    idx = y0 * W + x0
    if slot is not None:
        idx = idx + slot.reshape((-1,) + (1,) * (idx.dim() - 1)) * (H * W)
    q = packed.reshape(-1)[idx]
    Ia = (q & 0xff).to(torch.float32)
    Ib = ((q >> 8) & 0xff).to(torch.float32)
    Ic = ((q >> 16) & 0xff).to(torch.float32)
    Id = ((q >> 24) & 0xff).to(torch.float32)
    out = (Ia * (1 - fx) * (1 - fy) + Ib * fx * (1 - fy)
           + Ic * (1 - fx) * fy + Id * fx * fy)
    return torch.where(valid, out, torch.as_tensor(fillval, dtype=out.dtype,
                                                   device=out.device))


def _grid(h, w, dev):
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing='ij')
    return gx, gy


def affine_warp_blocks(img, origins, A, b, block_h, block_w, fillval=0.0):
    """Render N blocks of (block_h, block_w) output pixels: pixel (y, x)
    of block n sits at world origins[n] + (x, y) and samples the source
    at that point @ A[n] + b[n] (row-vector affine). Returns
    (N, block_h, block_w) float32."""
    img = img.to(torch.float32)
    gx, gy = _grid(block_h, block_w, img.device)
    o = origins.to(torch.float32)[:, None, None, :]
    A = A.to(torch.float32)[:, None, None]
    b = b.to(torch.float32)[:, None, None, :]
    px = gx + o[..., 0]
    py = gy + o[..., 1]
    sx = px * A[..., 0, 0] + py * A[..., 1, 0] + b[..., 0]
    sy = px * A[..., 0, 1] + py * A[..., 1, 1] + b[..., 1]
    return bilinear_sample(img, sx, sy, fillval)


def affine_warp_blocks_shifted(img, origins, A, b, h, w, K, fillval=0.0):
    """Affine block warp with the shifted-window semantics of the JAX
    package's TPU path, sampled directly.

    The JAX version rewrites each bilinear sample as a (2K+2)^2 static-
    shift sum over one window per block, only to avoid TPU gathers. This
    samples the same source pixels directly: each block's coordinates are
    taken relative to its integer window base ``floor(origin @ A + b) - K``
    exactly as there, and a neighbour contributes only when it lies inside
    that block's (h+2K+2, w+2K+2) window, so pixels whose deviation exceeds
    K get zero weight, as in the window sum. Outside the image reads
    ``fillval``; outside [0, W-1] x [0, H-1] the output is ``fillval``.

    img (H, W) with (N, ...) tables, or (P, H, W) with (P, N, ...) tables.
    Returns (N, h, w) or (P, N, h, w) float32.
    """
    single = img.dim() == 2
    if single:
        img, origins, A, b = img[None], origins[None], A[None], b[None]
    Pn, H, W = img.shape
    dev = img.device
    imgf = img.to(torch.float32)
    Pad = K + 2 + max(h, w)
    imgp = torch.nn.functional.pad(imgf, (Pad, Pad, Pad, Pad), value=fillval)
    Hp, Wp = H + 2 * Pad, W + 2 * Pad
    o = origins.to(torch.float32)
    A = A.to(torch.float32)
    b = b.to(torch.float32)
    base_x = o[..., 0] * A[..., 0, 0] + o[..., 1] * A[..., 1, 0] + b[..., 0]
    base_y = o[..., 0] * A[..., 0, 1] + o[..., 1] * A[..., 1, 1] + b[..., 1]
    bx = torch.clamp(torch.floor(base_x) - K, -Pad, W + Pad - w - 2 * K - 2)
    by = torch.clamp(torch.floor(base_y) - K, -Pad, H + Pad - h - 2 * K - 2)
    gx, gy = _grid(h, w, dev)
    e = (Ellipsis, None, None)
    sx = base_x[e] + gx * A[..., 0, 0][e] + gy * A[..., 1, 0][e]
    sy = base_y[e] + gx * A[..., 0, 1][e] + gy * A[..., 1, 1][e]
    rx = sx - bx[e]
    ry = sy - by[e]
    ixf = torch.floor(rx)
    iyf = torch.floor(ry)
    fx = rx - ixf
    fy = ry - iyf
    # shift of the left/top neighbour relative to the output pixel; the
    # window holds shifts 0 .. 2K+1
    ix = ixf - gx
    iy = iyf - gy
    top = 2 * K + 1
    wx0 = torch.where((ix >= 0) & (ix <= top), 1.0 - fx, 0.0)
    wx1 = torch.where((ix >= -1) & (ix <= top - 1), fx, 0.0)
    wy0 = torch.where((iy >= 0) & (iy <= top), 1.0 - fy, 0.0)
    wy1 = torch.where((iy >= -1) & (iy <= top - 1), fy, 0.0)
    # padded-image indices of the top-left neighbour, clamped so that
    # zero-weight neighbours never index out of bounds
    X0 = torch.clamp(bx[e] + ixf + Pad, 0, Wp - 2).to(torch.int64)
    Y0 = torch.clamp(by[e] + iyf + Pad, 0, Hp - 2).to(torch.int64)
    pidx = torch.arange(Pn, device=dev).reshape(
        (Pn,) + (1,) * (X0.dim() - 1)) * (Hp * Wp)
    i00 = pidx + Y0 * Wp + X0
    flat = imgp.reshape(-1)
    out = (wy0 * (wx0 * flat[i00] + wx1 * flat[i00 + 1])
           + wy1 * (wx0 * flat[i00 + Wp] + wx1 * flat[i00 + Wp + 1]))
    valid = (sx >= 0) & (sy >= 0) & (sx <= W - 1) & (sy <= H - 1)
    out = torch.where(valid, out, torch.as_tensor(fillval, dtype=out.dtype,
                                                  device=dev))
    return out[0] if single else out


_K_BUCKETS = (2, 3, 4, 6, 8)


def shift_bound_K(A, h, w):
    """Smallest K bucket bounding the within-window deviation
    |(x,y)@(A-I)| + 1 over an (h, w) block, or None when no bucket fits
    (host, numpy)."""
    dev = np.abs(np.asarray(A) - np.eye(2))
    worst = float((dev[..., 0, :].max(axis=-1) * w
                   + dev[..., 1, :].max(axis=-1) * h).max()) if dev.size else 0.0
    need = int(np.ceil(worst + 1.0))
    for k in _K_BUCKETS:
        if need <= k:
            return k
    return None


def warp_blocks_auto(img, origins, A, b, h, w, fillval=0.0, K=None):
    """Batched affine block warp: shifted-window semantics when the
    deformation fits a K bucket, plain gather otherwise."""
    if K is None:
        K = shift_bound_K(A.cpu().numpy(), h, w)
    if K is None:
        return affine_warp_blocks(img, origins, A, b, h, w, fillval=fillval)
    return affine_warp_blocks_shifted(img, origins, A, b, h, w, int(K),
                                      fillval=fillval)


def mesh_blocks_device(mesh, image, centers, block_size, gear=None,
                       fillval=0.0, src_offset=(0.0, 0.0)):
    """Render equal-size blocks centred at world points through a mesh's
    deformation on the device (local-affine approximation).

    ``image`` is a tensor on the compute device (INITIAL frame). Returns
    (stack (N, h, w) float32 tensor, kept indices (M,) numpy); blocks
    whose centre lies outside the mesh are dropped.
    """
    from feabas_tpu_torch import constant as const
    if gear is None:
        gear = (const.MESH_GEAR_MOVING, const.MESH_GEAR_INITIAL)
    dev = image.device
    centers = np.asarray(centers, np.float64).reshape(-1, 2)
    tid = mesh.tri_finder(centers, gear=gear[0], extrapolate=False)
    kept = np.nonzero(tid >= 0)[0]
    h = w = int(round(block_size))
    if kept.size == 0:
        return torch.zeros((0, h, w), dtype=torch.float32, device=dev), kept
    A_all, b_all = mesh.triangle_affine_tform(gear0=gear[0], gear1=gear[1])
    A = A_all[tid[kept]]
    b = b_all[tid[kept]] - np.asarray(src_offset, np.float64)
    origins = np.round(centers[kept] - [w / 2, h / 2])
    n = kept.size
    nb = max(8, 1 << (int(n - 1).bit_length()))
    if nb > n:
        pad = nb - n
        A = np.concatenate([A, np.repeat(A[:1], pad, axis=0)])
        b = np.concatenate([b, np.repeat(b[:1], pad, axis=0)])
        origins = np.concatenate([origins, np.repeat(origins[:1], pad, axis=0)])
    K = shift_bound_K(A, h, w)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    stack = warp_blocks_auto(image, t(origins), t(A), t(b), h, w,
                             fillval=float(fillval), K=K)
    return stack[:n], kept
