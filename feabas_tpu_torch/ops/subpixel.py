"""Subpixel refinement of matched keypoint pairs: the hand-written CUDA
kernel (``csrc/subpixel_refine.cu``) and its plain PyTorch version.

The per-match stage of ``thumbnail.refine_matches_subpixel`` on two
band-passed (DoG) images: for each pair of integer window centres, the
valid-lag correlation of a (P + 2s)^2 window of ``dog0`` with a P^2 window
of ``dog1`` (both less their means), its first maximum, the interior and
strength tests, and 8 symmetric-gradient Lucas-Kanade steps around the
peak. The wrapper takes the centres on the host, checks that every window
lies inside its image and uploads them in one copy; on CPU images it runs
the plain version, on CUDA images it launches the kernel or raises. Either
way it returns one (K, 3) float32 tensor on the images' device, rows of
(dx, dy, good): the measured shift of ``c0``'s content, (0, 0, 0) where the
peak is weak or on the border of the lags.
"""

import ctypes

import numpy as np
import torch

from feabas_tpu_torch import build
from feabas_tpu_torch import device as device_mod

LK_STEPS = 8
_LIB = None


def _windows(img, cx, cy, start, size):
    """(K, size, size) windows of ``img`` whose first px sits ``start``
    before each centre (cx, cy)."""
    ar = torch.arange(size, device=img.device)
    ys = (cy - start)[:, None] + ar
    xs = (cx - start)[:, None] + ar
    return img[ys[:, :, None], xs[:, None, :]]


# ------------------------------ plain version ------------------------------ #

def subpixel_refine_plain(dog0, dog1, centres, patch=32, search=6):
    """The function on (K, 4) integer ``centres`` rows (x0, y0, x1, y1):
    the host route's arithmetic of ``thumbnail.refine_matches_subpixel``
    after its DoGs, in float32 with the shift kept in float64. Returns
    (K, 3) float32 rows of (dx, dy, good)."""
    P, s = int(patch), int(search)
    N, L = P + 2 * s, 2 * s + 1
    K = centres.shape[0]
    out = torch.zeros((K, 3), dtype=torch.float32, device=dog0.device)
    if K == 0:
        return out
    c = centres.to(torch.int64)
    p0 = _windows(dog0, c[:, 0], c[:, 1], P // 2 + s, N)
    p1 = _windows(dog1, c[:, 2], c[:, 3], P // 2, P)
    p0 = p0 - p0.mean(dim=(1, 2), keepdim=True)
    p1 = p1 - p1.mean(dim=(1, 2), keepdim=True)
    # the valid-lag correlation, lag by lag: the sum the FFT takes
    C = torch.stack([(p0[:, i:i + P, j:j + P] * p1).sum(dim=(1, 2))
                     for i in range(L) for j in range(L)], 1)
    arg = C.argmax(dim=1)                       # the first maximum
    py, px = arg // L, arg % L
    interior = (px > 0) & (px < 2 * s) & (py > 0) & (py < 2 * s)
    e0 = torch.sqrt((p0 ** 2).sum(dim=(1, 2)))
    e1 = torch.sqrt((p1 ** 2).sum(dim=(1, 2)))
    peak = C.gather(1, arg[:, None])[:, 0]
    good = interior & (peak > 0.1 * e0 * e1 * (P / N))
    ii = torch.nonzero(good)[:, 0]
    G = ii.numel()
    if G == 0:
        return out
    py, px = py[ii], px[ii]
    # the window around the peak, one px wider each side
    ar = torch.arange(P + 2, device=dog0.device)
    w0pad = p0[ii[:, None, None], (py - 1)[:, None, None] + ar[:, None],
               (px - 1)[:, None, None] + ar]
    w1 = p1[ii]
    sub = torch.zeros((G, 2), dtype=torch.float64, device=dog0.device)
    rows = torch.arange(G, device=dog0.device)
    for _ in range(LK_STEPS):
        off = 1.0 + sub
        i0 = torch.clamp(torch.floor(off), 0, 1).to(torch.int64)
        f = off - i0
        wx = torch.zeros((G, 3), dtype=torch.float64, device=dog0.device)
        wy = torch.zeros_like(wx)
        wx[rows, i0[:, 0]] = 1 - f[:, 0]
        wx[rows, i0[:, 0] + 1] = f[:, 0]
        wy[rows, i0[:, 1]] = 1 - f[:, 1]
        wy[rows, i0[:, 1] + 1] = f[:, 1]
        W = torch.zeros((G, P, P), dtype=torch.float32, device=dog0.device)
        for a in range(3):
            for b in range(3):
                # each term added in float64, the sum kept in float32
                wab = (wy[:, a] * wx[:, b])[:, None, None]
                W = (W + wab * w0pad[:, a:a + P, b:b + P]).to(torch.float32)
        r = (w1 - W)[:, 1:-1, 1:-1]
        S = w1 + W
        gx = (S[:, 1:-1, 2:] - S[:, 1:-1, :-2]) * 0.25
        gy = (S[:, 2:, 1:-1] - S[:, :-2, 1:-1]) * 0.25
        a11 = (gx * gx).sum(dim=(1, 2))
        a12 = (gx * gy).sum(dim=(1, 2))
        a22 = (gy * gy).sum(dim=(1, 2))
        bx = (gx * r).sum(dim=(1, 2))
        by = (gy * r).sum(dim=(1, 2))
        det = a11 * a22 - a12 * a12
        det = torch.where(det > 1e-12, det, torch.full_like(det, np.inf))
        sub[:, 0] = torch.clamp(sub[:, 0] + (a22 * bx - a12 * by) / det,
                                -1.0, 1.0)
        sub[:, 1] = torch.clamp(sub[:, 1] + (a11 * by - a12 * bx) / det,
                                -1.0, 1.0)
    out[ii, 0] = (px + sub[:, 0] - s).to(torch.float32)
    out[ii, 1] = (py + sub[:, 1] - s).to(torch.float32)
    out[ii, 2] = 1.0
    return out


# --------------------------------- kernel --------------------------------- #

def _lib():
    global _LIB
    if _LIB is None:
        _LIB = build.bind('subpixel_refine', {
            # dog0, w0, dog1, w1, centres, out; k, patch, search; stream
            'subpixel_refine_f32': [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p],
            'subpixel_refine_max_floats': []})
    return _LIB


def shared_floats(patch, search):
    """Floats of shared memory a block of the kernel takes."""
    n, lags = patch + 2 * search, 2 * search + 1
    return n * n + 3 * patch * patch + lags * lags


def _check(dog0, dog1, c0, c1, P, s):
    for name, d in (('dog0', dog0), ('dog1', dog1)):
        if d.dim() != 2 or d.dtype != torch.float32:
            raise TypeError(f'{name}: expected an (H, W) float32 plane, got '
                            f'{tuple(d.shape)} {d.dtype}')
        if not d.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if dog0.device != dog1.device:
        raise ValueError(f'images on {dog0.device} and {dog1.device}')
    if P < 3 or s < 1:
        raise ValueError(f'patch {P} and search {s}: need patch >= 3 and '
                         'search >= 1')
    if c0.shape != c1.shape or c0.ndim != 2 or c0.shape[1] != 2:
        raise ValueError(f'centres {c0.shape} and {c1.shape}: expected two '
                         '(K, 2) arrays')
    # a window of `size` starts `start` before its centre
    for name, c, d, start, size in (('c0', c0, dog0, P // 2 + s, P + 2 * s),
                                    ('c1', c1, dog1, P // 2, P)):
        h, w = d.shape
        inside = ((c[:, 0] >= start) & (c[:, 0] - start + size <= w)
                  & (c[:, 1] >= start) & (c[:, 1] - start + size <= h))
        if not inside.all():
            raise ValueError(f'{name}: {int((~inside).sum())} windows reach '
                             'outside the image')


def subpixel_refine(dog0, dog1, c0, c1, patch=32, search=6):
    """Shifts of K matched pairs. dog0 (H0, W0), dog1 (H1, W1): float32 on
    one device; c0, c1: (K, 2) integer (x, y) window centres on the host,
    every window inside its image. Returns (K, 3) float32 on the images'
    device, rows of (dx, dy, good)."""
    P, s = int(patch), int(search)
    c0 = np.asarray(c0)
    c1 = np.asarray(c1)
    _check(dog0, dog1, c0, c1, P, s)
    centres = torch.from_numpy(
        np.concatenate([c0, c1], axis=1).astype(np.int32)).to(dog0.device)
    if dog0.device.type == 'cpu':
        return subpixel_refine_plain(dog0, dog1, centres, P, s)
    if dog0.device.type != 'cuda':
        raise ValueError(f'kernel needs CUDA tensors, got {dog0.device}')
    out = torch.empty((centres.shape[0], 3), dtype=torch.float32,
                      device=dog0.device)
    if centres.shape[0] > 0:
        launch(dog0, dog1, centres, out, P, s)
    return out


def launch(dog0, dog1, centres, out, patch, search):
    """One launch of the kernel on checked CUDA tensors: ``centres`` (K, 4)
    int32, ``out`` (K, 3) float32, both contiguous; counted as
    ``launch.subpixel_refine``."""
    lib = _lib()
    if shared_floats(patch, search) > lib.subpixel_refine_max_floats():
        raise ValueError(f'patch {patch} and search {search} need more '
                         'shared memory than the kernel takes')
    k = centres.shape[0]
    err = device_mod.launch_on(
        dog0.device.index, lib.subpixel_refine_f32, dog0.data_ptr(),
        dog0.shape[1], dog1.data_ptr(), dog1.shape[1], centres.data_ptr(),
        out.data_ptr(), k, patch, search)
    if err != 0:
        raise RuntimeError(f'subpixel_refine launch failed: CUDA error {err}')
    device_mod.count_launch('subpixel_refine', (k, patch, search))
