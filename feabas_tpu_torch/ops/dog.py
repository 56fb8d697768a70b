"""DoG band-pass and Gaussian blur: the hand-written CUDA kernel
(``csrc/dog_filter.cu``) and its plain PyTorch version.

Counterpart of ``feabas_tpu/ops/pallas_kernels.py:dog_filter``. The
wrappers take an (N, H, W) stack: on a CPU tensor they run the plain
version; on a CUDA tensor they launch the kernel or raise. Numerics follow
``ops.filters.gaussian_kernel1d`` (scipy ``gaussian_filter1d``, truncate 4,
'nearest' edges), rows first, then columns.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from feabas_tpu_torch import build, device

_LIB = None


def gaussian_kernel1d(sigma, radius=None, dtype=np.float32):
    if radius is None:
        radius = int(round(4.0 * float(sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    k /= k.sum()
    return k.astype(dtype)


# ------------------------------ plain version ------------------------------ #

def _blur1d(x, taps, dim):
    """Correlate (N, H, W) f32 along ``dim`` (-1 or -2) with 'nearest'
    edges, summing the taps in order."""
    r = (len(taps) - 1) // 2
    n = x.shape[dim]
    pad = (r, r, 0, 0) if dim == -1 else (0, 0, r, r)
    xp = F.pad(x[:, None], pad, mode='replicate')[:, 0]
    acc = None
    for k, wk in enumerate(taps):
        sl = xp.narrow(dim, k, n) * float(wk)
        acc = sl if acc is None else acc + sl
    return acc


def gaussian_blur_plain(stack, sigma):
    taps = gaussian_kernel1d(sigma)
    x = stack.to(torch.float32)
    return _blur1d(_blur1d(x, taps, -1), taps, -2)


def dog_filter_plain(stack, sigma=2.5):
    f0 = gaussian_blur_plain(stack, sigma)
    return f0 - gaussian_blur_plain(f0, sigma)


# --------------------------------- kernel --------------------------------- #

MAX_RADIUS = 24                       # csrc/dog_filter.cu kMaxRadius


def _lib():
    global _LIB
    if _LIB is None:
        # x, out, taps (host); radius, n, h, w; stream
        args = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
        lib = build.bind('dog_filter', {
            'dog_filter_f32': args, 'dog_filter_u8': args,
            'gaussian_blur_f32': args, 'dog_filter_max_radius': []})
        if lib.dog_filter_max_radius() != MAX_RADIUS:
            raise RuntimeError('csrc/dog_filter.cu kMaxRadius != '
                               f'{MAX_RADIUS}')
        _LIB = lib
    return _LIB


def _check(stack, dtypes):
    if stack.device.type != 'cuda':
        raise ValueError(f'kernel needs a CUDA tensor, got {stack.device}')
    if stack.dim() != 3:
        raise ValueError(f'expected an (N, H, W) stack, got {tuple(stack.shape)}')
    if stack.dtype not in dtypes:
        raise TypeError(f'unsupported dtype {stack.dtype}')
    if not stack.is_contiguous():
        raise ValueError('stack must be contiguous')


def _taps(sigma):
    """Host taps of ``sigma``; raises beyond the kernel's compiled radius."""
    taps = gaussian_kernel1d(sigma)
    radius = (taps.size - 1) // 2
    if radius > MAX_RADIUS:
        raise ValueError(f'sigma {sigma}: radius {radius} exceeds the '
                         f'kernel\'s maximum of {MAX_RADIUS}')
    return taps, radius


def _launch(fn_name, kernel, stack, sigma):
    n, h, w = stack.shape
    taps, radius = _taps(sigma)
    out = torch.empty((n, h, w), dtype=torch.float32, device=stack.device)
    stream = torch.cuda.current_stream(stack.device).cuda_stream
    with torch.cuda.device(stack.device):
        err = getattr(_lib(), fn_name)(
            stack.data_ptr(), out.data_ptr(), taps.ctypes.data, radius, n, h,
            w, stream)
    if err != 0:
        raise RuntimeError(f'{fn_name} launch failed: CUDA error {err}')
    device.count_launch(kernel, (n, h, w))
    return out


def dog_filter(stack, sigma=2.5):
    """f0 - blur(f0) with f0 = blur(stack), over an (N, H, W) uint8 or
    float32 stack; returns float32 (N, H, W)."""
    if stack.device.type == 'cpu':
        return dog_filter_plain(stack, sigma)
    _check(stack, (torch.float32, torch.uint8))
    fn = 'dog_filter_u8' if stack.dtype == torch.uint8 else 'dog_filter_f32'
    return _launch(fn, 'dog_filter', stack, sigma)


def gaussian_blur(stack, sigma):
    """Separable Gaussian blur of an (N, H, W) float32 stack."""
    if stack.device.type == 'cpu':
        return gaussian_blur_plain(stack, sigma)
    _check(stack, (torch.float32,))
    return _launch('gaussian_blur_f32', 'gaussian_blur', stack, sigma)
