"""Batched FFT cross-correlation on the device (counterpart of
``feabas_tpu/ops/xcorr.py``).

Per-pair displacement peaks with optional quadratic or DFT-upsampled
subpixel refinement, overlap normalization and the mirror-correlation
confidence, over an (N, H, W) stack. Transforms are ``torch.fft``.
"""

import math

import numpy as np
import torch

from feabas_tpu_torch import constant as const
from feabas_tpu_torch import device as device_mod

_FFT_SIZES = None


def good_fft_size(n, pow2=False):
    """Smallest size >= n that factors into 2,3,5 (or a power of two)."""
    n = int(n)
    if n <= 1:
        return 1
    if pow2:
        return 1 << (n - 1).bit_length()
    global _FFT_SIZES
    if _FFT_SIZES is None:
        sizes = set()
        p2 = 1
        while p2 <= (1 << 17):
            p3 = p2
            while p3 <= (1 << 17):
                p5 = p3
                while p5 <= (1 << 17):
                    sizes.add(p5)
                    p5 *= 5
                p3 *= 3
            p2 *= 2
        _FFT_SIZES = np.array(sorted(sizes))
    return int(_FFT_SIZES[np.searchsorted(_FFT_SIZES, n)])


def _local_dft_phases(iy, ix, fftshp, fxh, dev):
    fy, fx = fftshp
    ky = ((torch.arange(fy, device=dev) + fy // 2) % fy) - fy // 2
    kx = torch.arange(fxh, device=dev)
    wx = torch.full((fxh,), 2.0, dtype=torch.float32, device=dev)
    wx[0] = 1.0
    if fx % 2 == 0:
        wx[-1] = 1.0
    two_pi = 2.0 * math.pi
    ang_y = two_pi * iy[:, None].to(torch.float64) * ky[None, :] / fy
    ang_x = two_pi * ix[:, None].to(torch.float64) * kx[None, :] / fx
    phase_y = torch.polar(torch.ones_like(ang_y), ang_y).to(torch.complex64)
    phase_x = torch.polar(torch.ones_like(ang_x), ang_x).to(torch.complex64)
    return ky, kx, phase_y, phase_x * wx[None, :]


def _dft_upsample_offsets(Fc, iy, ix, fftshp, kappa, halfspan=0.75, Nc=None):
    """Subpixel peak offsets by local matrix-multiply DFT upsampling
    (Guizar-Sicairos local-DFT registration): the correlation surface near
    the integer peak is evaluated from the cross-power half-spectrum ``Fc``
    (N, fy, fx//2+1) on a ``2*halfspan`` px window at 1/``kappa`` px, then
    polished by a 3x3 quadratic fit. ``Nc`` (the mask-overlap
    half-spectrum) divides out the windowing envelope. The matmuls run in
    f32 with TF32 off (``device.py``). Returns (oy, ox) relative to
    (iy, ix)."""
    n = Fc.shape[0]
    fy, fx = fftshp
    fxh = Fc.shape[-1]
    dev = Fc.device
    P = int(2 * round(halfspan * kappa) + 1)
    delta = (torch.arange(P, dtype=torch.float32, device=dev)
             - (P - 1) / 2) / kappa
    ky, kx, phase_y, phase_xw = _local_dft_phases(iy, ix, fftshp, fxh, dev)
    ay = 2 * math.pi * delta[:, None] * ky[None, :].to(torch.float32) / fy
    ax = 2 * math.pi * delta[:, None] * kx[None, :].to(torch.float32) / fx
    Wyr, Wyi = torch.cos(ay), torch.sin(ay)
    Wxr, Wxi = torch.cos(ax), torch.sin(ax)

    def local_surface(S):
        Sr, Si = S.real, S.imag
        Tr = (torch.einsum('nkq,sq->nks', Sr, Wxr)
              - torch.einsum('nkq,sq->nks', Si, Wxi))
        Ti = (torch.einsum('nkq,sq->nks', Sr, Wxi)
              + torch.einsum('nkq,sq->nks', Si, Wxr))
        return (torch.einsum('pk,nks->nps', Wyr, Tr)
                - torch.einsum('pk,nks->nps', Wyi, Ti))        # (N, P, P)

    ramp = phase_y[:, :, None] * phase_xw[:, None, :]
    Cl = local_surface(Fc * ramp)
    if Nc is not None:
        Nl = local_surface(Nc * ramp)
        mx = Nl.reshape(n, -1).max(dim=-1).values[:, None, None]
        Cl = Cl / torch.maximum(Nl, 0.5 * torch.clamp(mx, min=1e-6))
    Cf = Cl.reshape(n, P * P)
    idx = torch.argmax(Cf, dim=-1)
    py = torch.clamp(idx // P, 1, P - 2)
    px = torch.clamp(idx % P, 1, P - 2)
    g = torch.stack([(py - 1) * P + px, (py + 1) * P + px,
                     py * P + px - 1, py * P + px + 1, py * P + px], -1)
    Ct = torch.gather(Cf, 1, g)
    cyy = Ct[:, 0] + Ct[:, 1] - 2 * Ct[:, 4]
    cxx = Ct[:, 2] + Ct[:, 3] - 2 * Ct[:, 4]
    oy_f = torch.where(cyy < 0, (Ct[:, 0] - Ct[:, 1]) / (2 * cyy), 0.0)
    ox_f = torch.where(cxx < 0, (Ct[:, 2] - Ct[:, 3]) / (2 * cxx), 0.0)
    oy = delta[py] + torch.clamp(oy_f, -0.5, 0.5) / kappa
    ox = delta[px] + torch.clamp(ox_f, -0.5, 0.5) / kappa
    return oy, ox


def _peak_and_subpixel(C, fftshp, subpixel, Fc=None, Nc=None):
    """argmax of (N, fy, fx) correlation surfaces + subpixel refinement.
    ``subpixel``: falsy = integer peak; True/1 = 3x3 quadratic fit;
    int >= 2 = local DFT upsampling at that factor (needs ``Fc`` and
    ``Nc``). Returns (dx, dy, peak_val)."""
    n = C.shape[0]
    fy, fx = fftshp
    Cf = C.reshape(n, fy * fx)
    idx = torch.argmax(Cf, dim=-1)
    peak = torch.gather(Cf, 1, idx[:, None])[:, 0]
    dy = (idx // fx).to(torch.float32)
    dx = (idx % fx).to(torch.float32)
    kappa = int(subpixel) if not isinstance(subpixel, bool) else 0
    if kappa >= 2 and Fc is not None and Nc is not None:
        oy, ox = _dft_upsample_offsets(Fc, dy, dx, fftshp, kappa, Nc=Nc)
        return dx + ox, dy + oy, peak
    if subpixel:
        off = torch.tensor([-1, 0, 1], device=C.device)
        iy = torch.remainder((idx // fx)[:, None] + off[None, :], fy)
        ix = torch.remainder((idx % fx)[:, None] + off[None, :], fx)
        flat = (iy[:, :, None] * fx + ix[:, None, :]).reshape(n, 9)
        Ct = torch.gather(Cf, 1, flat)           # row-major 3x3: [yy, xx]
        tx = (Ct[:, 5] - Ct[:, 3]) / 2
        ty = (Ct[:, 7] - Ct[:, 1]) / 2
        txx = Ct[:, 3] + Ct[:, 5] - 2 * Ct[:, 4]
        tyy = Ct[:, 7] + Ct[:, 1] - 2 * Ct[:, 4]
        txy = (Ct[:, 0] + Ct[:, 8] - Ct[:, 2] - Ct[:, 6]) / 4
        det = txx * tyy - txy * txy
        safe = det > 0
        det = torch.where(safe, det, 1.0)
        ox = torch.where(safe, -(tyy * tx - txy * ty) / det, 0.0)
        oy = torch.where(safe, -(-txy * tx + txx * ty) / det, 0.0)
        dx = dx + torch.clamp(ox, -0.5, 0.5)
        dy = dy + torch.clamp(oy, -0.5, 0.5)
    return dx, dy, peak


def _normalizer_from(F, fftshp, clip=0.1):
    """Relative mask-overlap surface from its half-spectrum, clipped
    below at ``clip``."""
    fy, fx = fftshp
    NC = torch.fft.irfft2(F, s=fftshp).reshape(-1, fy * fx)
    NC = NC / torch.clamp(NC.max(dim=-1, keepdim=True).values, min=1.0)
    return torch.clamp(NC, min=clip)


def mirror_confidence(C_raw, F0, F1, fftshp, Cm_div=None):
    """1 - max|xcorr(img0, mirrored img1)| / max xcorr, clipped to [0, 1]:
    a texture that matches itself mirrored as well as it matches the
    partner is periodic or degenerate."""
    n = C_raw.shape[0]
    Cm = torch.fft.irfft2(F0 * F1, s=fftshp).abs().reshape(n, -1)
    if Cm_div is not None:
        Cm = Cm / Cm_div
    mx_rl = C_raw.reshape(n, -1).max(dim=-1).values
    mx_mr = Cm.max(dim=-1).values
    pos = mx_rl > 0
    conf = torch.where(pos, 1.0 - mx_mr / torch.where(pos, mx_rl, 1.0), 0.0)
    return torch.clamp(conf, 0.0, 1.0)


def _xcorr_core(img0, img1, mask0, mask1, fftshp, shp0, shp1, conf_mode,
                subpixel, normalize):
    """img0: (N,H0,W0), img1: (N,H1,W1), pre-filtered. Returns
    (dx, dy, conf): centre of img1 + (dx, dy) matches centre of img0."""
    fy, fx = fftshp
    n = img0.shape[0]
    F0 = torch.fft.rfft2(img0.to(torch.float32), s=fftshp)
    F1 = torch.fft.rfft2(img1.to(torch.float32), s=fftshp)
    Fc = torch.conj(F0) * F1
    Cf = torch.fft.irfft2(Fc, s=fftshp).reshape(n, fy * fx)
    Nc = None
    peak_only = normalize == 'peak'
    if normalize:
        M0 = torch.fft.rfft2(mask0, s=fftshp)
        M1 = torch.fft.rfft2(mask1, s=fftshp)
        Nc = torch.conj(M0) * M1
        if peak_only:
            # peak localization only: clamp at 0.5 relative overlap
            Cn = Cf / _normalizer_from(Nc, fftshp, clip=0.5)
        else:
            Cn = Cf / _normalizer_from(Nc, fftshp)
            Cf = Cn
    else:
        Cn = Cf
    dx, dy, _peak = _peak_and_subpixel(Cn.reshape(n, fy, fx), fftshp,
                                       subpixel, Fc=Fc, Nc=Nc)
    # recentre: displacement between image centres, wrapped to the torus
    dy = dy + (shp0[0] - shp1[0]) / 2
    dx = dx + (shp0[1] - shp1[1]) / 2
    dy = dy - torch.round(dy / fy) * fy
    dx = dx - torch.round(dx / fx) * fx
    if conf_mode == const.FFT_CONF_NONE:
        conf = torch.ones_like(dx)
    elif conf_mode == const.FFT_CONF_MIRROR:
        div = None
        if normalize and not peak_only:
            div = _normalizer_from(M0 * M1, fftshp)
        conf = mirror_confidence(Cf, F0, F1, fftshp, Cm_div=div)
    elif conf_mode == const.FFT_CONF_STD:
        c_std = Cf.std(dim=-1, unbiased=False)
        conf = (1.0 - torch.exp(-Cf.max(dim=-1).values / c_std)) ** (fy * fx)
        conf = torch.clamp(conf, 0.0, 1.0)
    else:
        raise ValueError(f'unknown conf mode {conf_mode}')
    return dx, dy, conf


def xcorr_fft(img0, img1, conf_mode=const.FFT_CONF_MIRROR, device=None,
              **kwargs):
    """Batched displacement from FFT cross-correlation.

    Args:
        img0: (N,H0,W0) or (H0,W0) tensor or array; img1 likewise.
        device: where host arrays go (tensors stay where they are).
    Kwargs (as the JAX package): sigma, mask0, mask1, normalize,
        subpixel, pad, pow2, return_device.
    Returns:
        (dx, dy, conf) numpy arrays of shape (N,), or with
        ``return_device`` one (3, N) tensor.
    """
    from feabas_tpu_torch.ops.filters import masked_dog_filter
    sigma = kwargs.get('sigma', 0)
    mask0 = kwargs.get('mask0', None)
    mask1 = kwargs.get('mask1', None)
    normalize = kwargs.get('normalize', False)
    normalize = normalize if normalize == 'peak' else bool(normalize)
    subpixel = kwargs.get('subpixel', False)
    subpixel = int(subpixel) if not isinstance(subpixel, bool) else subpixel
    pad = kwargs.get('pad', True)
    pow2 = kwargs.get('pow2', True)
    if not torch.is_tensor(img0):
        img0 = torch.as_tensor(np.asarray(img0),
                               device=device_mod.get_device(device))
    img1 = torch.as_tensor(np.asarray(img1) if not torch.is_tensor(img1)
                           else img1, device=img0.device)
    dev = img0.device
    squeeze = img0.dim() == 2
    if squeeze:
        img0, img1 = img0[None], img1[None]
    if sigma > 0:
        # normalize='peak' reserves the masks for peak normalization only
        dog_m0 = None if normalize == 'peak' else mask0
        dog_m1 = None if normalize == 'peak' else mask1
        img0 = masked_dog_filter(img0, sigma, mask=_mask_tensor(dog_m0, dev))
        img1 = masked_dog_filter(img1, sigma, mask=_mask_tensor(dog_m1, dev))
    shp0 = tuple(int(s) for s in img0.shape[-2:])
    shp1 = tuple(int(s) for s in img1.shape[-2:])
    if pad:
        fftshp = tuple(good_fft_size(s0 + s1 - 1, pow2=pow2)
                       for s0, s1 in zip(shp0, shp1))
    else:
        fftshp = tuple(good_fft_size(max(s0, s1), pow2=pow2)
                       for s0, s1 in zip(shp0, shp1))

    def _expand_mask(m, shp):
        if m is None:
            return torch.ones((1,) + shp, dtype=torch.float32, device=dev)
        m = _mask_tensor(m, dev).to(torch.float32)
        return m[None] if m.dim() == 2 else m

    m0 = _expand_mask(mask0, shp0)
    m1 = _expand_mask(mask1, shp1)
    dx, dy, conf = _xcorr_core(img0, img1, m0, m1, fftshp, shp0, shp1,
                               int(conf_mode), subpixel, normalize)
    stacked = torch.stack([dx.to(torch.float32), dy.to(torch.float32),
                           conf.to(torch.float32)])
    if kwargs.get('return_device', False):
        return stacked
    out = stacked.cpu().numpy()
    dx, dy, conf = out[0], out[1], out[2]
    if squeeze:
        return dx[0], dy[0], conf[0]
    return dx, dy, conf


def _mask_tensor(m, dev):
    if m is None:
        return None
    if torch.is_tensor(m):
        return m.to(dev)
    return torch.as_tensor(np.asarray(m), device=dev)
