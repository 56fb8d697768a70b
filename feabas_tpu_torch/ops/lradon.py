"""Device thumbnail feature pipeline: DoG keypoint detection, local-Radon
descriptor extraction and rotation-exhaustive descriptor matching
(counterpart of ``feabas_tpu/ops/lradon.py``).

Three hand-written CUDA kernels carry the device work, each beside its plain
PyTorch version:

- ``peak_response`` (``csrc/peak_detect.cu``): the max-pool peak test of the
  detector and the response plane its top-k reads. The band-pass before it
  goes through ``ops.dog`` (the DoG kernel, and the blur kernel for a mask).
- ``lradon_patch`` (``csrc/lradon_patch.cu``): per-keypoint patch blended
  by its fractional offset, times the sparse sampling stencil, and the
  normalisation.
- ``lradon_match`` (``csrc/lradon_match.cu``): similarity over all 2P
  rotation variants, best-rotation selection, mutual-nearest check and
  ratio-test confidence, reduced on the device in column chunks: only O(K)
  vectors leave it.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. Detection returns a fixed-size top-k keypoint
table with a validity mask, ordered as ``jax.lax.top_k`` orders it (equal
responses by ascending flat index), and descriptor counts are padded to
power-of-two buckets, so the row layout of ``des_dev`` equals the JAX
package's.

A pair prepared together (``pair_features_device``: both images' features
and the round-0 match) runs inside the span ``thumbnail.features``, as
``thumbnail.prepare_image`` does for one image. Each kernel launches
through ``device.launch_on`` (inside the span ``launch``) and is counted as
``launch.<kernel>``.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from feabas_tpu_torch import build, trace
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch.ops.filters import masked_dog_filter

_LIBS = {}


def _require_cuda(name, **tensors):
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device.type != 'cuda':
            raise ValueError(f'{name}: {key} must be a CUDA tensor, got '
                             f'{t.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {key} must be contiguous')


# ------------------------- detection ------------------------- #

MAX_PEAK_SIZE = 32                    # csrc/peak_detect.cu kMaxSize


def peak_response_plain(f, mask=None, size=10):
    """Response plane of the detector from the band-passed image ``f``
    (H, W): |f| where it is the maximum of its ``size`` x ``size`` window,
    positive and inside ``mask``; -inf elsewhere. An even window reaches
    ``(size - 1) // 2`` px before the pixel and ``size // 2`` after it, as
    XLA's 'SAME' padding does; outside the image counts as -inf."""
    a = f.abs()
    lo, hi = (size - 1) // 2, size // 2
    mx = F.pad(a[None, None], (0, 0, lo, hi), value=float('-inf'))
    mx = F.max_pool2d(mx, (size, 1), stride=1)
    mx = F.pad(mx, (lo, hi, 0, 0), value=float('-inf'))
    mx = F.max_pool2d(mx, (1, size), stride=1)[0, 0]
    peaks = (a >= mx) & (a > 0)
    if mask is not None:
        peaks = peaks & (mask > 0)
    return torch.where(peaks, a, torch.full_like(a, float('-inf')))


def _peak_lib():
    if 'peak_detect' not in _LIBS:
        lib = build.bind('peak_detect', {
            # f, mask, resp; h, w, size; stream
            'peak_detect_f32': ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                + [ctypes.c_void_p]),
            'peak_detect_max_size': []})
        if lib.peak_detect_max_size() != MAX_PEAK_SIZE:
            raise RuntimeError('csrc/peak_detect.cu kMaxSize != '
                               f'{MAX_PEAK_SIZE}')
        _LIBS['peak_detect'] = lib
    return _LIBS['peak_detect']


def peak_response(f, mask=None, size=10):
    """``peak_response_plain`` through the CUDA kernel. f: (H, W) float32;
    mask: (H, W) float32 or None; returns (H, W) float32."""
    size = int(size)
    if f.device.type == 'cpu':
        return peak_response_plain(f, mask, size)
    _require_cuda('peak_response', f=f, mask=mask)
    if f.dim() != 2 or f.dtype != torch.float32:
        raise TypeError(f'expected an (H, W) float32 plane, got '
                        f'{tuple(f.shape)} {f.dtype}')
    if mask is not None and (mask.shape != f.shape
                             or mask.dtype != torch.float32):
        raise TypeError('mask must be a float32 plane of the image\'s shape')
    if not 1 <= size <= MAX_PEAK_SIZE:
        raise ValueError(f'window {size} outside the kernel\'s 1..'
                         f'{MAX_PEAK_SIZE}')
    h, w = f.shape
    resp = torch.empty_like(f)
    err = device_mod.launch_on(
        f.device.index, _peak_lib().peak_detect_f32, f.data_ptr(),
        None if mask is None else mask.data_ptr(), resp.data_ptr(), h, w,
        size)
    if err != 0:
        raise RuntimeError(f'peak_detect launch failed: CUDA error {err}')
    device_mod.count_launch('peak_detect', (h, w))
    return resp


def _detect_core(img, mask, sigma, size, k, has_mask):
    """DoG + max-pool peaks + top-k + subpixel fit on the device of
    ``img`` (H, W) float32. Returns tensors (xy (k, 2), resp (k,), valid
    (k,), yy (k,), xx (k,)), response-sorted descending, equal responses by
    ascending flat index."""
    h, w = img.shape
    f = masked_dog_filter(img[None], float(sigma),
                          mask=mask[None] if has_mask else None,
                          signed=False)[0]
    resp = peak_response(f, mask if has_mask else None, size)
    # a stable descending sort keeps the lower flat index first among equal
    # responses, which torch.topk does not promise
    order = torch.sort(resp.reshape(-1), descending=True, stable=True)
    vals, idx = order.values[:k], order.indices[:k]
    yy = idx // w
    xx = idx % w
    valid = torch.isfinite(vals)
    # subpixel: 1D quadratic fit along each axis at interior peaks
    inner = (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1) & valid
    yc = torch.clamp(yy, 1, h - 2)
    xc = torch.clamp(xx, 1, w - 2)
    c0 = f[yc, xc]
    cxx = f[yc, xc - 1] + f[yc, xc + 1] - 2 * c0
    cyy = f[yc - 1, xc] + f[yc + 1, xc] - 2 * c0
    zero = torch.zeros_like(c0)
    ox = torch.where(cxx < 0, (f[yc, xc - 1] - f[yc, xc + 1]) / (2 * cxx),
                     zero)
    oy = torch.where(cyy < 0, (f[yc - 1, xc] - f[yc + 1, xc]) / (2 * cyy),
                     zero)
    xs = xx.to(torch.float32) + torch.where(
        inner, torch.clamp(ox, -0.5, 0.5), zero)
    ys = yy.to(torch.float32) + torch.where(
        inner, torch.clamp(oy, -0.5, 0.5), zero)
    return (torch.stack([xs, ys], -1), torch.where(valid, vals, zero), valid,
            yy, xx)


def _detect_statics(shape, sigma, min_spacing, num_features):
    size = max(int(round(min_spacing)), 3)
    k = int(num_features) if num_features and num_features > 0 else 5000
    k = min(k, int(shape[0]) * int(shape[1]))
    return float(sigma), size, k


def _plane(a, dev):
    """A host image or mask as a contiguous float32 plane on ``dev``."""
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                           device=dev)


def detect_log_device(img, mask=None, sigma=3.5, min_spacing=10,
                      num_features=5000, device=None):
    """Device DoG + local-max detection. Returns host arrays
    (xy (n, 2) f64, resp (n,), iyx (n, 2) int — integer peak locations for
    mask/class lookups), n <= num_features, response-sorted descending."""
    dev = device_mod.get_device(device)
    img = _plane(img, dev)
    has_mask = mask is not None
    m = _plane(mask, dev) if has_mask else None
    sigma, size, k = _detect_statics(img.shape, sigma, min_spacing,
                                     num_features)
    xy, resp, valid, yy, xx = _detect_core(img, m, sigma, size, k, has_mask)
    n = int(valid.sum())
    return (xy.cpu().numpy().astype(np.float64)[:n], resp.cpu().numpy()[:n],
            np.stack([yy.cpu().numpy()[:n], xx.cpu().numpy()[:n]], -1))


# ------------------------- LRadon descriptors ------------------------- #

_STENCIL_CACHE = {}
_STENCIL_DEVICE_CACHE = {}


def _stencil_table64(proj_num, beam_num, beam_wd, D, offs, Rp):
    """(4, P*B, Dp*Dp) f64 sampling-stencil matrix, host-precomputed and
    cached.

    Row (t*B + b) of corner plane c = (cy, cx) holds the mean bilinear
    stencil of the beam window's D*wd taps at patch positions
    ``(Rp, Rp) + R(t) @ (a, offs_b + v) + (cx, cy)`` — i.e. the LRadon
    bin evaluated on the integer-corner-shifted patch. The descriptor at
    a fractional keypoint offset is the bilinear blend of the four
    corner evaluations. Plane (cy, cx) is plane (0, 0) shifted by (cx, cy)
    pixels, exactly (the same taps at integer-shifted positions)."""
    key = (proj_num, beam_num, beam_wd, D, Rp, offs.tobytes())
    if key in _STENCIL_CACHE:
        return _STENCIL_CACHE[key]
    Dp = 2 * Rp + 1
    r = (D - 1) // 2
    a = np.arange(D, dtype=np.float64) - r
    v = np.arange(beam_wd, dtype=np.float64) - (beam_wd - 1) / 2.0
    bp = offs[:, None].astype(np.float64) + v[None, :]        # (B, wd)
    W = np.zeros((2, 2, proj_num * beam_num, Dp * Dp), np.float64)
    for it in range(proj_num):
        th = it * (np.pi / proj_num)
        ci, si = np.cos(th), np.sin(th)
        dx = a[:, None, None] * ci + bp[None] * si            # (D, B, wd)
        dy = -a[:, None, None] * si + bp[None] * ci
        for cy in (0, 1):
            for cx in (0, 1):
                px = dx + Rp + cx
                py = dy + Rp + cy
                x0 = np.floor(px).astype(np.int64)
                y0 = np.floor(py).astype(np.int64)
                fx = px - x0
                fy = py - y0
                assert x0.min() >= 0 and y0.min() >= 0 \
                    and x0.max() + 1 < Dp and y0.max() + 1 < Dp
                for xx, yy, ww in ((x0, y0, (1 - fx) * (1 - fy)),
                                   (x0 + 1, y0, fx * (1 - fy)),
                                   (x0, y0 + 1, (1 - fx) * fy),
                                   (x0 + 1, y0 + 1, fx * fy)):
                    flat = yy * Dp + xx                       # (D, B, wd)
                    for b in range(beam_num):
                        np.add.at(W[cy, cx, it * beam_num + b],
                                  flat[:, b, :].ravel(),
                                  ww[:, b, :].ravel() / (D * beam_wd))
    W = W.reshape(4, proj_num * beam_num, Dp * Dp)
    _STENCIL_CACHE[key] = W
    return W


def _stencil_table(proj_num, beam_num, beam_wd, D, offs, Rp):
    """The stencil matrix of ``_stencil_table64`` in f32, the values both
    the plain version and the kernel use."""
    return _stencil_table64(proj_num, beam_num, beam_wd, D, offs,
                            Rp).astype(np.float32)


# csrc/lradon_patch.cu reads tap offsets as unsigned 16-bit integers
MAX_PATCH_PX = 1 << 15


def _stencil_taps(W0):
    """The non-zero taps of the corner-(0, 0) plane ``W0`` (PB, Dp^2), the
    sparse table the kernel holds in shared memory: (off (S, PB) int16,
    wts (S, PB) of W0's type), column q listing bin q's taps in ascending
    p and padded to the longest bin's S with (0, 0.0), which add nothing."""
    if W0.shape[1] > MAX_PATCH_PX:
        raise ValueError(f'{W0.shape[1]} patch pixels: tap offsets must fit '
                         f'16 bits (at most {MAX_PATCH_PX})')
    nz = W0 != 0
    S = max(1, int(nz.sum(1).max()))
    off = np.zeros((S, W0.shape[0]), np.int16)
    wts = np.zeros((S, W0.shape[0]), W0.dtype)
    for q in range(W0.shape[0]):
        p = np.nonzero(nz[q])[0]
        off[:p.size, q] = p
        wts[:p.size, q] = W0[q, p]
    return off, wts


def _stencil_tensors(proj_num, beam_num, beam_wd, D, offs, Rp, dev):
    """The stencil tables on ``dev``, uploaded once per geometry: (W
    (4, P*B, Dp^2) for the plain version, and the kernel's sparse corner
    plane ``_stencil_taps(W[0])``: off (S, P*B) int16, wts (S, P*B) f32)."""
    key = (proj_num, beam_num, beam_wd, D, Rp, offs.tobytes(), str(dev))
    if key not in _STENCIL_DEVICE_CACHE:
        W = _stencil_table(proj_num, beam_num, beam_wd, D, offs, Rp)
        off, wts = _stencil_taps(W[0])
        _STENCIL_DEVICE_CACHE[key] = tuple(
            torch.from_numpy(a).to(dev) for a in (W, off, wts))
    return _STENCIL_DEVICE_CACHE[key]


def lradon_patch_plain(img, z, f, W, proj_num, Rp):
    """Patch + stencil-matmul LRadon evaluation. img (H, W) float32
    (unpadded); z (K, 2) integer patch origins (x, y) in the frame
    edge-padded by ``Rp + 1``; f (K, 2) fractional offsets; W the stencil
    table (4, P*B, Dp^2). Returns (K, P, B) unit descriptors."""
    Dp = 2 * Rp + 1
    imgp = F.pad(img[None, None], (Rp + 1,) * 4, mode='replicate')[0, 0]
    ar = torch.arange(Dp, device=img.device)
    zz = z.long()
    rows = zz[:, 1, None, None] + ar[None, :, None]
    cols = zz[:, 0, None, None] + ar[None, None, :]
    Pm = imgp[rows, cols].reshape(zz.shape[0], -1)            # (K, Dp^2)
    M = (Pm @ W.reshape(-1, W.shape[-1]).T).reshape(zz.shape[0], 4, -1)
    fx, fy = f[:, 0], f[:, 1]
    wc = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                      (1 - fx) * fy, fx * fy], dim=1)         # (K, 4)
    des = (wc[:, :, None] * M).sum(dim=1)
    des = des.reshape(des.shape[0], proj_num, -1)             # (K, P, B)
    des = des - des.mean(dim=(1, 2), keepdim=True)
    nrm = torch.linalg.norm(des.reshape(des.shape[0], -1), dim=-1)
    return des / torch.clamp(nrm, min=1e-6)[:, None, None]


def _patch_lib():
    if 'lradon_patch' not in _LIBS:
        _LIBS['lradon_patch'] = build.bind('lradon_patch', {
            # img, h, w, z, frac, tap_off, tap_w, S, out, K, Dp, PB, pad,
            # stream
            'lradon_patch_f32': (
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])})
    return _LIBS['lradon_patch']


def lradon_patch(img, z, f, tables, proj_num, Rp):
    """``lradon_patch_plain`` through the CUDA kernel, which clamps its
    reads into the image instead of padding it, blends each keypoint's
    patch by its fractional offset once, and applies the sparse corner-(0,
    0) plane to it (the four corner planes are that plane shifted by one
    pixel, so ``sum_c wc_c W_c . patch == W_0 . blend``). ``tables`` is the
    triple (W, off, wts) of ``_stencil_tensors``."""
    W, off, wts = tables
    if img.device.type == 'cpu':
        return lradon_patch_plain(img, z, f, W, proj_num, Rp)
    z = z.to(torch.int32).contiguous()
    f = f.contiguous()
    _require_cuda('lradon_patch', img=img, z=z, f=f, off=off, wts=wts)
    if img.dim() != 2 or img.dtype != torch.float32 \
            or f.dtype != torch.float32 or wts.dtype != torch.float32 \
            or off.dtype != torch.int16:
        raise TypeError('lradon_patch takes float32 tensors and int16 tap '
                        'offsets')
    K, Dp = int(z.shape[0]), 2 * int(Rp) + 1
    S, PB = int(wts.shape[0]), int(wts.shape[1])
    if off.shape != wts.shape or W.shape[1:] != (PB, Dp * Dp) \
            or PB % proj_num or z.shape != (K, 2) or f.shape != (K, 2):
        raise ValueError(f'taps {tuple(wts.shape)}, z {tuple(z.shape)}, f '
                         f'{tuple(f.shape)} do not fit Rp {Rp}')
    out = torch.empty((K, proj_num, PB // proj_num), dtype=torch.float32,
                      device=img.device)
    if K == 0:
        return out
    h, w = img.shape
    err = device_mod.launch_on(
        img.device.index, _patch_lib().lradon_patch_f32, img.data_ptr(), h,
        w, z.data_ptr(), f.data_ptr(), off.data_ptr(), wts.data_ptr(), S,
        out.data_ptr(), K, Dp, PB, int(Rp) + 1)
    if err != 0:
        raise RuntimeError(f'lradon_patch launch failed: CUDA error {err}')
    device_mod.count_launch('lradon_patch', (K, PB))
    return out


def _desc_params(proj_num, beam_num, beam_wd, beam_radius):
    """Shared descriptor geometry: beam box width D, the beam offsets,
    and the patch radius Rp that contains every rotated tap."""
    r = float(beam_radius)
    D = 2 * int(round(r)) + 1
    ax = np.linspace(-r, r, D)
    idx = np.linspace(0, D - 1, beam_num).round().astype(np.int64)
    offs = np.asarray(ax[idx], np.float32)
    wd_half = (beam_wd - 1) / 2.0
    Rp = int(np.ceil(np.hypot(r, np.abs(ax[idx]).max() + wd_half))) + 2
    return D, offs, Rp


def lradon_descriptors_device(img, xy, proj_num=6, beam_num=8, beam_wd=3,
                              beam_radius=15, device=None):
    """Device LRadon descriptors for keypoints ``xy`` (n, 2).
    Returns a device (n_pad, P, B) f32 tensor and n (callers slice)."""
    dev = device_mod.get_device(device)
    imgh = np.asarray(img, np.float32)
    h, w = imgh.shape
    D, offs, Rp = _desc_params(proj_num, beam_num, beam_wd, beam_radius)
    n = int(np.asarray(xy).shape[0])
    # pad the keypoint count to pow2 buckets, the JAX package's row layout
    n_pad = max(64, 1 << (n - 1).bit_length()) if n else 64
    xyp = np.zeros((n_pad, 2), np.float32)
    if n:
        # clamp into the image like the direct sampler's coordinate clip
        xyp[:n] = np.clip(np.asarray(xy, np.float32),
                          0.0, [w - 1.0, h - 1.0])
    # patch origins in the frame edge-padded by Rp + 1, where every patch
    # slice is in bounds
    pad = Rp + 1
    z0 = np.floor(xyp)
    f = torch.as_tensor(xyp - z0, dtype=torch.float32, device=dev)
    z = torch.as_tensor(z0.astype(np.int32) + (pad - Rp), device=dev)
    tables = _stencil_tensors(int(proj_num), int(beam_num), int(beam_wd), D,
                              offs, Rp, dev)
    des = lradon_patch(_plane(imgh, dev), z, f, tables, int(proj_num), Rp)
    return des, n


# ------------------------- matching ------------------------- #

def _variants(des, proj_num):
    """(2P, K, P*B) rotation variants: rotating the image by k*pi/P
    cyclically shifts projections (flipping the offset axis past the
    wrap); the second P variants add a half-turn (full flip)."""
    k0 = des.shape[0]
    out = []
    for b in (des, des.flip(2)):
        for k in range(proj_num):
            rolled = torch.roll(b, -k, dims=1)
            if k > 0:
                rolled = torch.cat(
                    [rolled[:, :proj_num - k],
                     rolled[:, proj_num - k:].flip(2)], dim=1)
            out.append(rolled.reshape(k0, -1))
    return torch.stack(out)


_PERM_CACHE = {}


def _variant_perms(proj_num, beam_num, dev):
    """(2P, P*B) int32 on ``dev``: variant r of a descriptor set ``d`` is
    ``d.reshape(K, -1)[:, perms[r]]`` (row 0 is the identity)."""
    key = (proj_num, beam_num, str(dev))
    if key not in _PERM_CACHE:
        ids = torch.arange(proj_num * beam_num, dtype=torch.int32)
        perms = _variants(ids.reshape(1, proj_num, beam_num), proj_num)[:, 0]
        _PERM_CACHE[key] = perms.contiguous().to(dev)
    return _PERM_CACHE[key]


def lradon_match_plain(d0, v0, d1, v1, proj_num, exhaustive=True):
    """Masked matching of descriptor sets d0 (K0, P, B), d1 (K1, P, B)
    with bool validity masks v0, v1. The rotation search scans the
    variants of d1 with one running-best (K1, K0) similarity plane; the
    first variant with the strictly largest maximum wins. Returns (i0
    (K1,) first argmax per row, top (K1,), conf (K1,), mutual (K1,) bool,
    best_rot 0-d int)."""
    k0, k1 = d0.shape[0], d1.shape[0]
    a0 = d0.reshape(k0, -1)
    vmask = v1[:, None] & v0[None, :]
    ninf = torch.tensor(float('-inf'), dtype=torch.float32, device=d0.device)
    best_rot = torch.zeros((), dtype=torch.int32, device=d0.device)
    if exhaustive:
        S = torch.full((k1, k0), float('-inf'), dtype=torch.float32,
                       device=d0.device)
        m_best = ninf.clone()
        for ri, vr in enumerate(_variants(d1, proj_num)):
            Sr = torch.where(vmask, vr @ a0.T, ninf)
            m = Sr.max()
            take = m > m_best                        # first max wins ties
            S = torch.where(take, Sr, S)
            m_best = torch.where(take, m, m_best)
            best_rot = torch.where(take, torch.full_like(best_rot, ri),
                                   best_rot)
    else:
        S = torch.where(vmask, d1.reshape(k1, -1) @ a0.T, ninf)
    i0 = _first_argmax(S, 1)                         # (K1,)
    top = S.max(dim=1).values
    S2 = S.clone()
    S2[torch.arange(k1, device=S.device), i0] = float('-inf')
    second = S2.max(dim=1).values
    back = _first_argmax(S, 0)                       # (K0,)
    mutual = back[i0] == torch.arange(k1, device=S.device)
    conf = torch.where(top > 0,
                       1 - torch.clamp(second, min=0)
                       / torch.clamp(top, min=1e-6),
                       torch.zeros_like(top))
    return i0, top, conf, mutual & v1, best_rot


def _first_argmax(S, dim):
    """argmax along ``dim`` that returns the first index among equal
    maxima (``torch.argmax`` promises no order)."""
    n = S.shape[dim]
    ids = torch.arange(n, device=S.device)
    ids = ids[None, :] if dim == 1 else ids[:, None]
    is_max = S == S.max(dim=dim, keepdim=True).values
    return torch.where(is_max, ids, torch.full_like(ids, n)).min(dim=dim).values


MATCH_TILE = 128                      # csrc/lradon_match.cu kBN (= kBM)
MATCH_VARIANTS_PER_BLOCK = 2          # csrc/lradon_match.cu kVar


def _match_lib():
    if 'lradon_match' not in _LIBS:
        lib = build.bind('lradon_match', {
            # d0, v0, d1, v1, perms, nvar, d0t, gmax, rowkeys, colkey, i0,
            # top, conf, mutual, best_rot, K0, K1, dlen, chunks1, chunks2,
            # stream
            'lradon_match_f32': (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 9
                + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
            'lradon_match_tile': [], 'lradon_match_variants_per_block': []})
        if (lib.lradon_match_tile(), lib.lradon_match_variants_per_block()) \
                != (MATCH_TILE, MATCH_VARIANTS_PER_BLOCK):
            raise RuntimeError('csrc/lradon_match.cu kBN, kVar != '
                               f'{MATCH_TILE}, {MATCH_VARIANTS_PER_BLOCK}')
        _LIBS['lradon_match'] = lib
    return _LIBS['lradon_match']


def _match_plan(K0, K1, nvar, sms):
    """Grid of the match kernels on a card of ``sms`` SMs: (K0p, the column
    count padded to whole tiles; chunks1, chunks2, the column chunks of
    passes 1 and 2). Pass 1 has row tiles x variant groups blocks before
    the split, pass 2 row tiles: each is split over columns until it about
    fills the card at two blocks per SM, and never into more chunks than
    there are column tiles."""
    col_tiles = -(-int(K0) // MATCH_TILE)
    row_tiles = -(-int(K1) // MATCH_TILE)
    groups = -(-int(nvar) // MATCH_VARIANTS_PER_BLOCK)
    chunks1 = max(1, min(col_tiles, round(2 * sms / (row_tiles * groups))))
    chunks2 = max(1, min(col_tiles, 2 * sms // row_tiles))
    return col_tiles * MATCH_TILE, chunks1, chunks2


_SMS = {}


def _sm_count(dev):
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def lradon_match(d0, v0, d1, v1, proj_num, exhaustive=True):
    """``lradon_match_plain`` through the CUDA kernels: no similarity plane
    is written to memory."""
    if d0.device.type == 'cpu':
        return lradon_match_plain(d0, v0, d1, v1, proj_num, exhaustive)
    _require_cuda('lradon_match', d0=d0, v0=v0, d1=d1, v1=v1)
    if d0.dtype != torch.float32 or d1.dtype != torch.float32 \
            or v0.dtype != torch.bool or v1.dtype != torch.bool:
        raise TypeError('lradon_match takes float32 descriptors and bool '
                        'masks')
    if d0.dim() != 3 or d1.dim() != 3 or d0.shape[1:] != d1.shape[1:] \
            or d0.shape[1] != proj_num or v0.shape != d0.shape[:1] \
            or v1.shape != d1.shape[:1]:
        raise ValueError(f'descriptor sets {tuple(d0.shape)}, '
                         f'{tuple(d1.shape)} and masks {tuple(v0.shape)}, '
                         f'{tuple(v1.shape)} do not fit')
    dev = d0.device
    K0, K1 = int(d0.shape[0]), int(d1.shape[0])
    if K0 == 0 or K1 == 0:
        raise ValueError('lradon_match needs at least one row on each side')
    dlen = int(d0.shape[1] * d0.shape[2])
    perms = _variant_perms(int(proj_num), int(d0.shape[2]), dev)
    nvar = int(perms.shape[0]) if exhaustive else 1
    K0p, chunks1, chunks2 = _match_plan(K0, K1, nvar, _sm_count(dev))
    d0t = torch.empty((dlen, K0p), dtype=torch.float32, device=dev)
    gmax = torch.empty(nvar, dtype=torch.int32, device=dev)
    rowkeys = torch.empty((chunks2, 2, K1), dtype=torch.int64, device=dev)
    colkey = torch.empty(K0, dtype=torch.int64, device=dev)
    i0 = torch.empty(K1, dtype=torch.int32, device=dev)
    top = torch.empty(K1, dtype=torch.float32, device=dev)
    conf = torch.empty(K1, dtype=torch.float32, device=dev)
    mutual = torch.empty(K1, dtype=torch.bool, device=dev)
    best_rot = torch.empty((), dtype=torch.int32, device=dev)
    err = device_mod.launch_on(
        dev.index, _match_lib().lradon_match_f32, d0.data_ptr(),
        v0.data_ptr(), d1.data_ptr(), v1.data_ptr(), perms.data_ptr(), nvar,
        d0t.data_ptr(), gmax.data_ptr(), rowkeys.data_ptr(),
        colkey.data_ptr(), i0.data_ptr(), top.data_ptr(), conf.data_ptr(),
        mutual.data_ptr(), best_rot.data_ptr(), K0, K1, dlen, chunks1,
        chunks2)
    if err != 0:
        raise RuntimeError(f'lradon_match launch failed: CUDA error {err}')
    device_mod.count_launch('lradon_match', (K1, K0, nvar))
    return i0.long(), top, conf, mutual, best_rot


def match_lradon_device(des0, n0, des1, n1, exhaustive=True,
                        conf_thresh=0.5):
    """Mutual-nearest descriptor matching with the reduction on device.
    des0/des1: (K_pad, P, B) device tensors from
    ``lradon_descriptors_device``. Returns (idx0, idx1, conf, best_rot)
    exactly like the host ``match_LRadon_feature``."""
    if n0 == 0 or n1 == 0:
        return (np.zeros(0, int), np.zeros(0, int), np.zeros(0), 0)
    v0 = torch.arange(des0.shape[0], device=des0.device) < int(n0)
    v1 = torch.arange(des1.shape[0], device=des1.device) < int(n1)
    # mutual carries v1, so no padded row survives the thresholds
    out = lradon_match(des0, v0, des1, v1, int(des0.shape[1]),
                       bool(exhaustive))
    return _match_postprocess(*out, conf_thresh=conf_thresh)


def _match_postprocess(i0, top, conf, mutual, best_rot, conf_thresh):
    """Shared host-side thresholding of a raw device match. ``mutual``
    already carries the side-1 validity/active mask, so the surviving
    indices are GLOBAL rows of the (padded) descriptor arrays."""
    i0 = i0.cpu().numpy()
    top = top.cpu().numpy()
    conf = conf.cpu().numpy()
    mutual = mutual.cpu().numpy()
    keep = mutual & (conf > conf_thresh) & (top > 0.1)
    i1 = np.nonzero(keep)[0]
    return i0[keep], i1, conf[keep], int(best_rot)


def match_lradon_device_masked(des0_dev, m0, des1_dev, m1, exhaustive=True,
                               conf_thresh=0.5):
    """Mutual-nearest matching on DEVICE-RESIDENT descriptor sets with
    host bool masks (valid & still-active). Per robustness round this
    uploads two (K,) bool vectors and fetches O(K) result vectors — the
    descriptors never leave the device. Returns GLOBAL indices
    (idx0, idx1, conf, best_rot) into the padded descriptor rows."""
    m0 = np.asarray(m0, bool)
    m1 = np.asarray(m1, bool)
    if not m0.any() or not m1.any():
        return (np.zeros(0, int), np.zeros(0, int), np.zeros(0), 0)
    proj_num = int(des0_dev.shape[1])
    out = lradon_match(
        des0_dev, torch.as_tensor(m0, device=des0_dev.device),
        des1_dev, torch.as_tensor(m1, device=des1_dev.device),
        proj_num, bool(exhaustive))
    return _match_postprocess(*out, conf_thresh=conf_thresh)


# ------------------- feature / pair programs ------------------- #
#
# The flow keeps the JAX package's shape: detect (keypoint tables fetched,
# image and per-keypoint z/f tables stay on the device), then descriptors at
# an ADAPTIVE pow2 bucket of the detected counts (the top rows of the
# response-sorted tables) and the round-0 rotation-exhaustive match. Later
# robustness rounds reuse the device-resident descriptors through
# ``match_lradon_device_masked``.

def _detect_prep_core(img, mask, sigma, size, k, has_mask, Rp):
    """Detect + descriptor-prep for one image: keypoints, their patch
    origins z / fractional offsets f (in the edge-padded frame the
    descriptor stage uses), and region class ids."""
    xy, resp, valid, yy, xx = _detect_core(img, mask, sigma, size, k,
                                           has_mask)
    h, w = img.shape
    # clamp into the image exactly like the host descriptor prep
    # (lradon_descriptors_device)
    hi = torch.tensor([w - 1.0, h - 1.0], dtype=torch.float32,
                      device=img.device)
    xyc = torch.minimum(torch.clamp(xy, min=0.0), hi)
    z0 = torch.floor(xyc)
    f = xyc - z0
    pad = Rp + 1
    z = z0.to(torch.int32) + (pad - Rp)
    if has_mask:
        cls = mask[yy, xx].to(torch.int32)
    else:
        cls = torch.zeros(yy.shape[0], dtype=torch.int32, device=img.device)
    return xy, resp, valid, yy, xx, cls, z, f


def _desc_core(img, z, f, tables, kd, proj_num, Rp):
    """Descriptors for the top-``kd`` (response-sorted) keypoints of one
    image; img / z / f are device residents from the detect stage."""
    return lradon_patch(img, z[:kd], f[:kd], tables, proj_num, Rp)


def _kd_bucket(n, k):
    """pow2 descriptor bucket covering the n detected keypoints (never
    drops one: n <= k always, and min(pow2(n), k) >= n)."""
    return int(min(max(64, 1 << max(int(n) - 1, 0).bit_length()), k))


def _detect_fetch(out, k):
    """Host-side unpack of one image's detect outputs (small tables);
    device handles (z, f, valid) ride along for the descriptor stage."""
    xy, resp, valid, yy, xx, cls, z, f = out
    n = int(valid.sum())              # the sort puts invalid (-inf) last
    return {
        'xy': xy.cpu().numpy().astype(np.float64)[:n],
        'resp': resp.cpu().numpy()[:n],
        'iyx': np.stack([yy.cpu().numpy()[:n], xx.cpu().numpy()[:n]], -1),
        'cls': cls.cpu().numpy()[:n],
        'n': n, 'k': int(k),
        '_z': z, '_f': f, '_v': valid,
    }


def _feature_prep(img, mask, sigma, min_spacing, num_features, Rp, dev):
    """Upload one image (and mask) and run its detect + prep stage."""
    img_dev = _plane(img, dev)
    has_mask = mask is not None
    m = _plane(mask, dev) if has_mask else None
    sigma, size, k = _detect_statics(img_dev.shape, sigma, min_spacing,
                                     num_features)
    out = _detect_prep_core(img_dev, m, sigma, size, k, has_mask, Rp)
    return img_dev, _detect_fetch(out, k), k


def _finish_features(feat, des):
    feat['des_dev'] = des
    feat['des'] = des.cpu().numpy()[:feat['n']]
    return feat


def features_device(img, mask=None, sigma=3.5, min_spacing=10,
                    num_features=5000, proj_num=6, beam_num=8, beam_wd=3,
                    beam_radius=15, device=None):
    """Detect + describe for one image. Returns a dict with host keypoint
    tables (xy/resp/iyx/cls, response-sorted, length n) and the
    device-resident (kd, P, B) descriptor tensor ``des_dev`` (rows past n
    are padding; pair it with a ``valid & active`` mask for
    ``match_lradon_device_masked``)."""
    dev = device_mod.get_device(device)
    D, offs, Rp = _desc_params(proj_num, beam_num, beam_wd, beam_radius)
    tables = _stencil_tensors(int(proj_num), int(beam_num), int(beam_wd), D,
                              offs, Rp, dev)
    img_dev, feat, k = _feature_prep(img, mask, sigma, min_spacing,
                                     num_features, Rp, dev)
    kd = _kd_bucket(feat['n'], k)
    des = _desc_core(img_dev, feat.pop('_z'), feat.pop('_f'), tables, kd,
                     int(proj_num), Rp)
    feat.pop('_v')
    return _finish_features(feat, des)


@trace.spanned('thumbnail.features')
def pair_features_device(img0, img1, mask0=None, mask1=None, sigma=3.5,
                         min_spacing=10, num_features=5000, proj_num=6,
                         beam_num=8, beam_wd=3, beam_radius=15,
                         exhaustive=True, conf_thresh=0.5, device=None):
    """Detect + describe BOTH images and run the round-0 match. Returns
    (feat0, feat1, (idx0, idx1, conf, best_rot)) where featN are
    ``features_device``-shaped dicts and the indices are global keypoint
    rows."""
    dev = device_mod.get_device(device)
    D, offs, Rp = _desc_params(proj_num, beam_num, beam_wd, beam_radius)
    tables = _stencil_tensors(int(proj_num), int(beam_num), int(beam_wd), D,
                              offs, Rp, dev)
    d0, feat0, k0 = _feature_prep(img0, mask0, sigma, min_spacing,
                                  num_features, Rp, dev)
    d1, feat1, k1 = _feature_prep(img1, mask1, sigma, min_spacing,
                                  num_features, Rp, dev)
    kd0 = _kd_bucket(feat0['n'], k0)
    kd1 = _kd_bucket(feat1['n'], k1)
    des0 = _desc_core(d0, feat0.pop('_z'), feat0.pop('_f'), tables, kd0,
                      int(proj_num), Rp)
    des1 = _desc_core(d1, feat1.pop('_z'), feat1.pop('_f'), tables, kd1,
                      int(proj_num), Rp)
    m = lradon_match(des0, feat0.pop('_v')[:kd0].contiguous(), des1,
                     feat1.pop('_v')[:kd1].contiguous(), int(proj_num),
                     bool(exhaustive))
    match = _match_postprocess(*m, conf_thresh=conf_thresh)
    return _finish_features(feat0, des0), _finish_features(feat1, des1), match
