"""Coarse section alignment from downsampled thumbnails (counterpart of
``feabas_tpu/thumbnail.py``).

Keypoint pipeline (capability parity with reference ``feabas/thumbnail.py``):
DoG extrema detection, local-Radon (LRadon) descriptors — beam integrals at
``proj_num`` orientations x ``beam_num`` offsets, rotation-normalizable by
cyclic shifts — exhaustive normalized-dot matching over rotations, geometric
consistency filters (pairwise strain + affine RANSAC), and a template
fallback. Produces coarse ``Match`` sets that seed the fine PMCC block
matcher. Detection, description and descriptor matching run on the device
that ``device.get_device`` resolves (``ops/lradon``: its plain PyTorch
versions on the CPU, three CUDA kernels on a card), and the subpixel
refinement of the coarse matches follows the feature stage there
(``ops/subpixel``: one more kernel). The filters, and the subpixel
refinement of keypoints carried in without device descriptors, are
numpy/scipy as in the JAX package, with the same seeded draws.

Spans (``trace``): ``thumbnail.features`` (detect + describe),
``thumbnail.feature_match`` (a robustness round's descriptor match and
strain filter), ``thumbnail.ransac``, ``thumbnail.subpixel``,
``thumbnail.verify`` and ``thumbnail.refine`` (the PMCC block matching).
Counters, of what the host already holds: ``thumbnail.keypoints`` (kept per
image), ``thumbnail.match_rounds``, ``thumbnail.ransac_calls`` and
``thumbnail.ransac_trials`` (each affine fit's draws),
``thumbnail.coarse_matches``, ``thumbnail.refined_matches``, and
``thumbnail.subpixel_calls``, ``.subpixel_on_device`` and
``.subpixel_kept`` (the subpixel refinement's calls, those on the card,
and the matches whose measured shift it wrote).
"""

import numpy as np

from feabas_tpu_torch import common, config, trace
from feabas_tpu_torch import constant as const
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch.common import Match
from feabas_tpu_torch.ops import lradon
from feabas_tpu_torch.spatial import fit_affine, apply_affine


class KeyPoints:
    """Keypoint set: xy (N,2), response (N,), class_id (N,) region labels,
    descriptors (N, proj_num, beam_num), orientation offsets (N,)
    (reference: thumbnail.py:29)."""

    def __init__(self, xy, response=None, class_id=None):
        self.xy = np.asarray(xy, np.float64).reshape(-1, 2)
        n = self.xy.shape[0]
        self.response = (np.zeros(n) if response is None
                         else np.asarray(response, np.float64).ravel())
        self.class_id = (np.zeros(n, np.int32) if class_id is None
                         else np.asarray(class_id, np.int32).ravel())
        self.des = None
        # device-resident (k_pad, P, B) descriptor tensor (rows beyond
        # num_points are padding) — set by the device prepare so
        # every matching round reuses it via a bool mask instead of
        # re-uploading descriptors (ops/lradon.match_lradon_device_masked)
        self.des_dev = None

    @property
    def num_points(self):
        return self.xy.shape[0]

    def filter_by_mask(self, keep):
        kp = KeyPoints(self.xy[keep], self.response[keep], self.class_id[keep])
        if self.des is not None:
            kp.des = self.des[keep]
        return kp

    def __getstate__(self):
        # the device handle is per-process; drop it when pickling to
        # worker processes (they re-upload lazily if they match on device)
        state = dict(self.__dict__)
        state['des_dev'] = None
        return state


class KeyPointMatches:
    """Matched keypoint pairs with per-side region labels (reference
    KeyPointMatches: thumbnail.py:173) — the container API reference users
    pass between the filter stages."""

    def __init__(self, xy0, xy1, conf=None, class_id0=None, class_id1=None):
        self.xy0 = np.asarray(xy0, np.float64).reshape(-1, 2)
        self.xy1 = np.asarray(xy1, np.float64).reshape(-1, 2)
        n = self.xy0.shape[0]
        self.conf = (np.ones(n) if conf is None
                     else np.asarray(conf, np.float64).ravel())
        self.class_id0 = (np.zeros(n, np.int32) if class_id0 is None
                          else np.asarray(class_id0, np.int32).ravel())
        self.class_id1 = (np.zeros(n, np.int32) if class_id1 is None
                          else np.asarray(class_id1, np.int32).ravel())

    @classmethod
    def from_keypoints(cls, kps0, kps1, idx0, idx1, conf=None):
        return cls(kps0.xy[idx0], kps1.xy[idx1], conf,
                   kps0.class_id[idx0], kps1.class_id[idx1])

    @property
    def num_points(self):
        return self.xy0.shape[0]

    def filter_match(self, keep, inplace=True):
        sub = KeyPointMatches(self.xy0[keep], self.xy1[keep], self.conf[keep],
                              self.class_id0[keep], self.class_id1[keep])
        if inplace:
            self.__dict__.update(sub.__dict__)
            return self
        return sub

    def to_match(self, strain=None):
        return Match(self.xy0, self.xy1, self.conf,
                     config.DEFAULT_AVG_DEFORM if strain is None else strain)


def detect_extrema_log(img, mask=None, sigma=3.5, min_spacing=10,
                       num_features=5000, device=None):
    """DoG band-pass + local-maximum keypoints (reference:
    thumbnail.py:605). Returns a KeyPoints (both polarities kept).

    The whole detect stage — DoG, max-pool peaks, top-k, subpixel
    quadratic fit — runs on ``device`` (``ops.lradon.detect_log_device``)
    and only the (k, 2) keypoint table is fetched."""
    xy, resp, iyx = lradon.detect_log_device(
        img, mask=mask, sigma=sigma, min_spacing=min_spacing,
        num_features=num_features, device=device)
    kp = KeyPoints(xy, resp)
    if mask is not None and np.asarray(mask).dtype != bool:
        kp.class_id = np.asarray(mask)[iyx[:, 0], iyx[:, 1]].astype(np.int32)
    return kp


def extract_LRadon_feature(img, kps, proj_num=6, beam_num=8, beam_wd=3,
                           beam_radius=15, device=None, **kwargs):
    """Local Radon descriptors (reference: thumbnail.py:634).

    For each keypoint, a disk patch is integrated along ``proj_num`` beam
    orientations (a local Radon transform) and sampled at ``beam_num``
    smoothed offsets. Descriptors are L2-normalized per keypoint; rotation
    acts as a cyclic shift of the projection axis (with sign flip of the
    offset axis after half a turn). They are computed on ``device``
    (``ops.lradon.lradon_descriptors_device``).
    """
    des, _ = lradon.lradon_descriptors_device(
        img, kps.xy, proj_num=proj_num, beam_num=beam_num, beam_wd=beam_wd,
        beam_radius=beam_radius, device=device)
    # fetched to host (K*P*B f32, ~1 MB at 5k keypoints) so the
    # robustness loop's per-round keypoint slicing works unchanged
    kps.des = des.cpu().numpy()[:kps.num_points]
    return kps


def match_LRadon_feature(kps0, kps1, exhaustive=True, conf_thresh=0.5,
                         device=None, **kwargs):
    """Descriptor matching over rotations with ratio-test confidence
    (reference: thumbnail.py:703). Returns (idx0, idx1, conf, rot_k).

    The similarities AND their reduction (best rotation, mutual-nearest,
    ratio test) run on the device (ops/lradon.lradon_match): the fetch is
    O(K) vectors, never a (2P, N1, N0) similarity tensor."""
    if kps0.num_points == 0 or kps1.num_points == 0:
        return (np.zeros(0, int), np.zeros(0, int), np.zeros(0), 0)
    import torch
    dev = device_mod.get_device(device)
    n0 = kps0.num_points
    n1 = kps1.num_points
    shape = kps0.des.shape[1:]

    def _pad(des, n):
        p = max(64, 1 << (n - 1).bit_length())
        out = np.zeros((p,) + shape, np.float32)
        out[:n] = des
        return torch.from_numpy(out).to(dev)

    return lradon.match_lradon_device(_pad(kps0.des, n0), n0,
                                      _pad(kps1.des, n1), n1,
                                      exhaustive=exhaustive,
                                      conf_thresh=conf_thresh)


def filter_match_pairwise_strain(xy0, xy1, conf=None, strain_limit=0.2,
                                 shear_limit=45, sample_ratio=0.05,
                                 inlier_thresh=0.5, maxiter=1000, **kwargs):
    """Keep matches whose pairwise distances agree (reference:
    thumbnail.py:766): for random match pairs, |d0|/|d1| must stay within
    the strain limit and relative angles within the shear limit; matches in
    the largest consistent set survive."""
    n = xy0.shape[0]
    if n < 4:
        return np.ones(n, bool)
    rng = np.random.default_rng(0)
    votes = np.zeros(n)
    trials = np.zeros(n) + 1e-6
    npairs = min(max(int(n * n * sample_ratio), 4 * n), maxiter * 4)
    ii = rng.integers(0, n, npairs)
    jj = rng.integers(0, n, npairs)
    ok_pair = ii != jj
    ii, jj = ii[ok_pair], jj[ok_pair]
    d0 = xy0[ii] - xy0[jj]
    d1 = xy1[ii] - xy1[jj]
    L0 = np.linalg.norm(d0, axis=-1)
    L1 = np.linalg.norm(d1, axis=-1)
    valid = (L0 > 1) & (L1 > 1)
    ratio = np.where(valid, L1 / np.clip(L0, 1e-6, None), np.inf)
    ang = np.abs(np.rad2deg(
        np.arctan2(common.cross2d(d0, d1), (d0 * d1).sum(-1))))
    good = valid & (np.abs(np.log(np.clip(ratio, 1e-6, None)))
                    < np.log(1 + strain_limit)) & (ang < shear_limit)
    np.add.at(votes, ii, good)
    np.add.at(votes, jj, good)
    np.add.at(trials, ii, valid)
    np.add.at(trials, jj, valid)
    return votes / trials >= inlier_thresh


@trace.spanned('thumbnail.ransac')
def filter_match_global_ransac(xy0, xy1, conf=None, **kwargs):
    """Weighted affine RANSAC (reference: thumbnail.py:835): inliers
    within ``dis_tol`` (4 px), at most ``maxiter`` (10000; 500 drawn).
    Returns (inlier_mask, T) with T the best row-vector affine xy1->xy0."""
    return _global_ransac(xy0, xy1, conf, **kwargs)


def _global_ransac(xy0, xy1, conf=None, dis_tol=4, maxiter=10000, **kwargs):
    n = xy0.shape[0]
    if n < 3:
        return np.ones(n, bool), np.eye(3)
    rng = np.random.default_rng(0)
    best_mask = np.zeros(n, bool)
    best_T = np.eye(3)
    iters = min(maxiter, 500)
    p = None
    if conf is not None and np.sum(conf) > 0:
        p = np.asarray(conf, np.float64)
        p = p / p.sum()
    trials = 0
    for _ in range(iters):
        trials += 1
        sel = rng.choice(n, 3, replace=False, p=p)
        try:
            T = fit_affine(xy0[sel], xy1[sel], avoid_flip=True)
        except np.linalg.LinAlgError:
            continue
        r = np.linalg.norm(apply_affine(xy1, T) - xy0, axis=-1)
        mask = r < dis_tol
        if mask.sum() > best_mask.sum():
            best_mask = mask
            best_T = T
            if mask.mean() > 0.8:
                break
    trace.count('thumbnail.ransac_calls')
    trace.count('thumbnail.ransac_trials', trials)
    if best_mask.sum() >= 3:
        best_T = fit_affine(xy0[best_mask], xy1[best_mask])
        r = np.linalg.norm(apply_affine(xy1, best_T) - xy0, axis=-1)
        best_mask = r < dis_tol
    return best_mask, best_T


@trace.spanned('thumbnail.ransac')
def filter_match_sequential_ransac(xy0, xy1, conf=None, class0=None,
                                   class1=None, min_features_ratio=0.1,
                                   max_rounds=10, mixed_class=False, **kwargs):
    """Peel off affine-consistent match groups one model at a time
    (reference sequential RANSAC: thumbnail.py:914).

    Sections broken into pieces (or montaged from regions that moved
    independently) have several affine models in one match set; a single
    global RANSAC keeps only the dominant one. Each round fits the best
    remaining model, restricts its inliers to the dominant region
    (class0/class1) pair unless ``mixed_class``, and removes them; stops
    when the residue pool is smaller than ``min_features_ratio`` x the
    first group. Returns a list of index arrays into the input matches.
    """
    n = xy0.shape[0]
    remaining = np.arange(n)
    groups = []
    min_features = None
    for _ in range(int(max_rounds)):
        if remaining.size < 3:
            break
        c = None if conf is None else conf[remaining]
        inl, T = _global_ransac(xy0[remaining], xy1[remaining], c, **kwargs)
        if inl.sum() < 3:
            break
        if (not mixed_class) and class0 is not None and class1 is not None:
            cid = (class0[remaining].astype(np.int64) * (2 ** 20)
                   + class1[remaining].astype(np.int64))
            vals, cnts = np.unique(cid[inl], return_counts=True)
            inl = inl & (cid == vals[np.argmax(cnts)])
            if inl.sum() < 3:
                break
        if min_features is None:
            min_features = max(5, int(inl.sum() * min_features_ratio))
        groups.append(remaining[inl])
        remaining = remaining[~inl]
        if remaining.size < min_features:
            break
    return groups


@trace.spanned('thumbnail.verify')
def verify_match_elastic(xy0, xy1, weight, settled, img_shape0, img_shape1,
                         dis_tol=10.0, mesh_size=None, device=None):
    """Verify a small candidate match group against the deformation
    implied by already-settled matches (reference elastic verification:
    thumbnail.py:392-414).

    Builds a two-mesh SLM, adds the settled matches as full-weight links
    and the candidates as a half-weight staging link, relaxes, and keeps
    candidates whose post-relaxation residues stay under ``dis_tol``.
    Returns a boolean keep mask.
    """
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.optimizer import SLM
    h0, w0 = img_shape0[:2]
    h1, w1 = img_shape1[:2]
    if mesh_size is None:
        mesh_size = max(min(h0, w0) / 6.0, 20)
    mesh0 = Mesh.from_bbox((0, 0, w0, h0), cartesian=True,
                           mesh_size=mesh_size, uid=0, locked=True)
    mesh1 = Mesh.from_bbox((0, 0, w1, h1), cartesian=True,
                           mesh_size=mesh_size, uid=1,
                           soft_factor=1.0 / config.MATCH_SOFTFACTOR_DOMINANCE)
    slm = SLM([mesh0, mesh1], device=device)
    s_xy0, s_xy1, s_w = settled
    slm.add_link_from_coordinates(0, 1, s_xy0, s_xy1, weight=s_w)
    staging = slm.add_link_from_coordinates(
        0, 1, xy0, xy1, weight=np.full(xy0.shape[0], 0.5), name='staging')
    slm.optimize_affine_cascade(start_gear=const.MESH_GEAR_INITIAL)
    slm.optimize_linear(tol=1e-6, stiffness_lambda=-0.5, crosslink_lambda=-1.0)
    r = staging.residues(gear=const.MESH_GEAR_MOVING)
    # from_coordinates may have dropped far-extrapolated points; map back
    keep = np.zeros(xy0.shape[0], bool)
    if r.size == xy0.shape[0]:
        keep = r < dis_tol
    else:  # conservative: verify what survived, drop the rest
        keep[:r.size] = r < dis_tol
    return keep


_DETECT_KEYS = ('sigma', 'min_spacing', 'num_features')
_EXTRACT_KEYS = ('proj_num', 'beam_num', 'beam_wd', 'beam_radius')


def _feature_kwargs(settings):
    """The feature calls' keywords from ``detect_settings`` and
    ``extract_settings``; other keys there are ignored."""
    detect = settings.get('detect_settings', {}) or {}
    extract = settings.get('extract_settings', {}) or {}
    kw = {k: detect[k] for k in _DETECT_KEYS if k in detect}
    kw.update({k: extract[k] for k in _EXTRACT_KEYS if k in extract})
    return kw


def _kp_from_device_features(feat, mask):
    kp = KeyPoints(feat['xy'], feat['resp'])
    if mask is not None and np.asarray(mask).dtype != bool:
        kp.class_id = feat['cls'].astype(np.int32)
    kp.des = feat['des']
    kp.des_dev = feat['des_dev']
    return kp


@trace.spanned('thumbnail.features')
def prepare_image(img, mask=None, device=None, **settings):
    """Detect + describe in one call; cached by callers
    (reference: thumbnail.py:279).

    The whole feature extraction stays on the device
    (ops/lradon.features_device), and the descriptors stay resident there
    for masked re-matching across robustness rounds."""
    feat = lradon.features_device(img, mask=mask, device=device,
                                  **_feature_kwargs(settings))
    kp = _kp_from_device_features(feat, mask)
    trace.count('thumbnail.keypoints', kp.num_points)
    return kp


@trace.spanned('thumbnail.subpixel')
def refine_matches_subpixel(img0, img1, xy0, xy1, sigma=3.5, patch=32,
                            search=6, device=None):
    """Subpixel refinement of matched keypoint pairs by local DoG
    cross-correlation.

    Keypoint matches pair two INDEPENDENT detections, so their positional
    error is the sum of two detector localization noises (~0.1-0.2 px
    median) — above the 0.1 px parity north star the dense matcher meets.
    Measuring the residual shift between the actual image content around
    each pair (valid-mode correlation + 3x3 quadratic subpixel peak)
    replaces detector coincidence with a direct displacement measurement,
    the same principle as the reference's PMCC refinement stage
    (reference: feabas/thumbnail.py:490-529) applied per match.

    Returns xy0_refined (xy1 is kept; only the correspondence target
    moves). Pairs whose correlation peak is weak, on the search border,
    or out of image bounds keep their original coordinates.

    With ``device`` a CUDA device (the one the feature stage ran on), both
    DoGs and the per-match fit run on the card (``ops.filters``' DoG
    kernel, then ``ops.subpixel``'s kernel): one upload of each image and
    of the centres, one copy back. Otherwise (None, or the CPU) the host
    computes it with scipy and numpy, as the JAX package does.

    Counters: ``thumbnail.subpixel_calls``, ``thumbnail.subpixel_on_device``
    (calls on the card) and ``thumbnail.subpixel_kept`` (matches whose
    measured shift was written).
    """
    dev = None if device is None else device_mod.get_device(device)
    on_card = dev is not None and dev.type == 'cuda'
    trace.count('thumbnail.subpixel_calls')
    if on_card:
        trace.count('thumbnail.subpixel_on_device')
    P, s = int(patch), int(search)
    h0, w0 = np.shape(img0)[:2]
    h1, w1 = np.shape(img1)[:2]
    c0 = np.rint(xy0).astype(np.int64)
    c1 = np.rint(xy1).astype(np.int64)
    ok = ((c0[:, 0] >= P // 2 + s) & (c0[:, 0] < w0 - P // 2 - s)
          & (c0[:, 1] >= P // 2 + s) & (c0[:, 1] < h0 - P // 2 - s)
          & (c1[:, 0] >= P // 2) & (c1[:, 0] < w1 - P // 2)
          & (c1[:, 1] >= P // 2) & (c1[:, 1] < h1 - P // 2))
    out = np.asarray(xy0, np.float64).copy()
    idx = np.nonzero(ok)[0]
    if idx.size == 0:
        return out
    if on_card:
        ii, dx, dy = _subpixel_shifts_card(img0, img1, c0[idx], c1[idx],
                                           float(sigma), P, s, dev)
    else:
        ii, dx, dy = _subpixel_shifts_host(img0, img1, c0[idx], c1[idx],
                                           float(sigma), P, s)
    trace.count('thumbnail.subpixel_kept', ii.size)
    # the measured correspondence is (c0 + d) <-> c1 (integer window
    # centers); translate back to the caller's fractional xy1 anchor:
    # content at xy1 = c1 + frac pairs with c0 + d + frac
    g = idx[ii]
    frac = np.asarray(xy1, np.float64)[g] - c1[g]
    out[g, 0] = c0[g, 0] + dx + frac[:, 0]
    out[g, 1] = c0[g, 1] + dy + frac[:, 1]
    return out


def _subpixel_shifts_card(img0, img1, c0, c1, sigma, P, s, dev):
    """``_subpixel_shifts_host`` on the CUDA device ``dev``: (ii, dx, dy)
    of the matches whose measured shift is kept, from the DoG kernel and
    the subpixel kernel."""
    import torch
    from feabas_tpu_torch.ops import filters, subpixel

    def dog(img):
        t = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
        return filters.masked_dog_filter(t, sigma)
    res = subpixel.subpixel_refine(dog(img0), dog(img1), c0, c1, P,
                                   s).cpu().numpy()
    ii = np.nonzero(res[:, 2] > 0)[0]
    return (ii, res[ii, 0].astype(np.float64),
            res[ii, 1].astype(np.float64))


def _subpixel_shifts_host(img0, img1, c0, c1, sigma, P, s):
    """(ii, dx, dy): the rows of the in-bounds centres ``c0``, ``c1`` whose
    correlation peak is strong and inside the lags, and their measured
    shifts of c0's content, with scipy and numpy."""
    from scipy import fft
    img0f = common.masked_dog_filter(np.asarray(img0, np.float32),
                                     sigma, signed=True)
    img1f = common.masked_dog_filter(np.asarray(img1, np.float32),
                                     sigma, signed=True)
    N = P + 2 * s
    n = c0.shape[0]
    p0 = np.empty((n, N, N), np.float32)
    p1 = np.zeros((n, N, N), np.float32)
    for k in range(n):
        x0, y0 = c0[k]
        x1, y1 = c1[k]
        p0[k] = img0f[y0 - P // 2 - s:y0 + (P + 1) // 2 + s,
                      x0 - P // 2 - s:x0 + (P + 1) // 2 + s]
        p1[k, :P, :P] = img1f[y1 - P // 2:y1 + (P + 1) // 2,
                              x1 - P // 2:x1 + (P + 1) // 2]
    p0 -= p0.mean(axis=(1, 2), keepdims=True)
    p1[:, :P, :P] -= p1[:, :P, :P].mean(axis=(1, 2), keepdims=True)
    C = fft.irfft2(fft.rfft2(p0) * np.conj(fft.rfft2(p1)), s=(N, N))
    C = C[:, :2 * s + 1, :2 * s + 1]          # valid lags only (no wrap)
    flat = C.reshape(n, -1)
    arg = np.argmax(flat, axis=-1)
    py, px = np.divmod(arg, 2 * s + 1)
    # discard border peaks (no room to refine) and weak peaks
    interior = (px > 0) & (px < 2 * s) & (py > 0) & (py < 2 * s)
    e0 = np.sqrt((p0 ** 2).sum(axis=(1, 2)))
    e1 = np.sqrt((p1 ** 2).sum(axis=(1, 2)))
    strong = flat[np.arange(n), arg] > 0.1 * e0 * e1 * (P / N)
    good = interior & strong
    ii = np.nonzero(good)[0]
    if ii.size == 0:
        return ii, np.zeros(0), np.zeros(0)
    K = ii.size
    # ---- subpixel: Lucas-Kanade gradient refinement around the integer
    # peak. The DoG-filtered correlation peak is several px wide here, so
    # a 3x3 quadratic fit is curvature-starved (measured ~0.5 px bias);
    # linearized brightness constancy on the aligned windows is exact in
    # the small-shift limit and converges in 2-3 iterations.
    pad = 1
    w0pad = np.empty((K, P + 2 * pad, P + 2 * pad), np.float32)
    for k, i in enumerate(ii):
        w0pad[k] = p0[i, py[i] - pad:py[i] + P + pad,
                      px[i] - pad:px[i] + P + pad]
    w1 = p1[ii, :P, :P]
    sub = np.zeros((K, 2), np.float64)         # fractional shift
    grid = np.arange(3)
    for _it in range(8):
        # bilinear window of p0 at (peak + sub), via one-hot row/col
        # weights over the 3x3 sub-window stencil of the padded crop
        off = pad + sub                         # in [0, 2]
        i0 = np.clip(np.floor(off).astype(np.int64), 0, 1)
        f = off - i0
        wx = np.zeros((K, 3))
        wy = np.zeros((K, 3))
        kk = np.arange(K)
        wx[kk, i0[:, 0]] = 1 - f[:, 0]
        wx[kk, i0[:, 0] + 1] = f[:, 0]
        wy[kk, i0[:, 1]] = 1 - f[:, 1]
        wy[kk, i0[:, 1] + 1] = f[:, 1]
        W = np.zeros((K, P, P), np.float32)
        for a in grid:
            for b in grid:
                wab = (wy[:, a] * wx[:, b])
                if not np.any(wab):
                    continue
                W += wab[:, None, None] * w0pad[:, a:a + P, b:b + P]
        r = (w1 - W)[:, 1:-1, 1:-1]
        # symmetric (ESM-style) gradient: mean of template and warped
        # window gradients — halves the bilinear-resampling gradient
        # mismatch that biases plain forward-additive LK
        gx1 = ((w1 + W)[:, 1:-1, 2:] - (w1 + W)[:, 1:-1, :-2]) * 0.25
        gy1 = ((w1 + W)[:, 2:, 1:-1] - (w1 + W)[:, :-2, 1:-1]) * 0.25
        a11 = (gx1 * gx1).sum(axis=(1, 2))
        a12 = (gx1 * gy1).sum(axis=(1, 2))
        a22 = (gy1 * gy1).sum(axis=(1, 2))
        det = a11 * a22 - a12 * a12
        det = np.where(det > 1e-12, det, np.inf)
        bx = (gx1 * r).sum(axis=(1, 2))
        by = (gy1 * r).sum(axis=(1, 2))
        # dW/dsub = spatial gradient of the sampled window,
        # so the Gauss-Newton step solves A delta = [gx.r, gy.r]
        dxk = (a22 * bx - a12 * by) / det
        dyk = (a11 * by - a12 * bx) / det
        sub[:, 0] = np.clip(sub[:, 0] + dxk, -1.0, 1.0)
        sub[:, 1] = np.clip(sub[:, 1] + dyk, -1.0, 1.0)
    return ii, px[ii] + sub[:, 0] - s, py[ii] + sub[:, 1] - s


def match_two_thumbnails_LRadon(img0, img1, mask0=None, mask1=None,
                                device=None, **settings):
    """Feature-based coarse matching (reference: thumbnail.py:336).

    Iterative robustness loop: detect -> describe -> rotation-exhaustive
    matching -> pairwise-strain filter -> SEQUENTIAL affine RANSAC (one
    model per section piece) -> elastic verification of small groups
    against settled matches -> mask out covered keypoints -> repeat until
    no new group survives. Returns a ``common.Match`` or None."""
    matching = dict(settings.get('matching_settings', {}) or {})
    strain_f = dict(settings.get('strain_filter_settings', {}) or {})
    ransac_f = dict(settings.get('ransac_filter_settings', {}) or {})
    matchnum_thresh = settings.get('matchnum_thresh', 64)
    # affine_only: every region pair contributes exactly ONE affine model
    # (reference: thumbnail.py:336,affine_only branch)
    affine_only = bool(settings.get('affine_only', False))
    maskout_radius = settings.get(
        'maskout_radius',
        2.0 * (settings.get('detect_settings', {}) or {}).get('min_spacing', 10))
    elastic_dis_tol = settings.get('elastic_dis_tol', None)
    max_rounds = int(settings.get('max_rounds', 4))
    kp0 = settings.get('kps0')
    kp1 = settings.get('kps1')
    pre_match = None
    if kp0 is None and kp1 is None:
        # whole pair prep + round-0 match stay on the device
        f0, f1, pre_match = lradon.pair_features_device(
            img0, img1, mask0=mask0, mask1=mask1,
            exhaustive=matching.get('exhaustive', True),
            conf_thresh=matching.get('conf_thresh', 0.3), device=device,
            **_feature_kwargs(settings))
        kp0 = _kp_from_device_features(f0, mask0)
        kp1 = _kp_from_device_features(f1, mask1)
        trace.count('thumbnail.keypoints', kp0.num_points + kp1.num_points)
    if kp0 is None:
        kp0 = prepare_image(img0, mask=mask0, device=device, **settings)
    if kp1 is None:
        kp1 = prepare_image(img1, mask=mask1, device=device, **settings)
    shape0 = np.asarray(img0).shape
    shape1 = np.asarray(img1).shape
    acc_xy0, acc_xy1, acc_w = [], [], []
    settled_by_cls = {}   # (class0, class1) -> [xy0, xy1, w] lists
    min_group = int(settings.get('min_group_size', 5))
    active0 = np.ones(kp0.num_points, bool)
    active1 = np.ones(kp1.num_points, bool)
    use_masked = kp0.des_dev is not None and kp1.des_dev is not None
    for _round in range(max_rounds):
        if int(active0.sum()) < 3 or int(active1.sum()) < 3:
            break
        trace.count('thumbnail.match_rounds')
        with trace.span('thumbnail.feature_match'):
            if use_masked:
                # descriptors stay device-resident; each round uploads only
                # the active masks and fetches the surviving global indices
                if _round == 0 and pre_match is not None:
                    i0, i1, conf, rot = pre_match
                else:
                    m0 = np.zeros(kp0.des_dev.shape[0], bool)
                    m0[:kp0.num_points] = active0
                    m1 = np.zeros(kp1.des_dev.shape[0], bool)
                    m1[:kp1.num_points] = active1
                    i0, i1, conf, rot = lradon.match_lradon_device_masked(
                        kp0.des_dev, m0, kp1.des_dev, m1,
                        exhaustive=matching.get('exhaustive', True),
                        conf_thresh=matching.get('conf_thresh', 0.3))
                src0, src1 = kp0, kp1        # global indices
            else:
                k0 = kp0.filter_by_mask(active0)
                k1 = kp1.filter_by_mask(active1)
                i0, i1, conf, rot = match_LRadon_feature(
                    k0, k1, exhaustive=matching.get('exhaustive', True),
                    conf_thresh=matching.get('conf_thresh', 0.3),
                    device=device)
                src0, src1 = k0, k1          # compacted indices
            if i0.size < 3:
                break
            xy0 = src0.xy[i0]
            xy1 = src1.xy[i1]
            keep = filter_match_pairwise_strain(xy0, xy1, conf, **strain_f)
            if _round > 0 and keep.sum() < 3:
                # later rounds see only leftover pieces: the pairwise-strain
                # vote can starve; fall back to raw RANSAC on the candidates
                keep = np.ones(xy0.shape[0], bool)
            if keep.sum() < 3:
                break
            xy0, xy1, conf = xy0[keep], xy1[keep], conf[keep]
        cls0 = src0.class_id[i0][keep]
        cls1 = src1.class_id[i1][keep]
        groups = filter_match_sequential_ransac(
            xy0, xy1, conf, class0=cls0, class1=cls1, **ransac_f)
        accepted_any = False
        for g in groups:
            gxy0, gxy1, gw = xy0[g], xy1[g], conf[g]
            # class pair of this group (sequential RANSAC makes groups
            # class-pure when class ids exist)
            cpair = (int(cls0[g[0]]), int(cls1[g[0]]))
            prior = settled_by_cls.get(cpair)
            if affine_only and prior is not None:
                continue  # this region pair already has its one model
            if prior is not None and g.size < matchnum_thresh:
                # small late group on an ALREADY matched piece: must be
                # elastically consistent with that piece's settled matches
                # (cross-piece verification would wrongly reject pieces
                # that moved independently)
                settled = (np.concatenate(prior[0]), np.concatenate(prior[1]),
                           np.concatenate(prior[2]))
                tol = elastic_dis_tol or max(maskout_radius, 8.0)
                keep_g = verify_match_elastic(gxy0, gxy1, gw, settled,
                                              shape0, shape1, dis_tol=tol,
                                              device=device)
                if keep_g.sum() < 3 or keep_g.mean() < 0.5:
                    continue
                gxy0, gxy1, gw = gxy0[keep_g], gxy1[keep_g], gw[keep_g]
            elif prior is None and g.size < min_group:
                continue  # unverifiable tiny group on a fresh piece
            acc_xy0.append(gxy0)
            acc_xy1.append(gxy1)
            acc_w.append(gw)
            ent = settled_by_cls.setdefault(cpair, ([], [], []))
            ent[0].append(gxy0)
            ent[1].append(gxy1)
            ent[2].append(gw)
            accepted_any = True
            # mask out covered keypoints so the next round looks at the
            # remaining (unmatched) section pieces
            from scipy.spatial import cKDTree
            if np.any(active0):
                d0, _ = cKDTree(gxy0).query(kp0.xy[active0], k=1)
                idx = np.nonzero(active0)[0]
                active0[idx[d0 < maskout_radius]] = False
            if np.any(active1):
                d1, _ = cKDTree(gxy1).query(kp1.xy[active1], k=1)
                idx = np.nonzero(active1)[0]
                active1[idx[d1 < maskout_radius]] = False
        if not accepted_any:
            break
    if not acc_xy0:
        return None
    xy0 = np.concatenate(acc_xy0)
    xy1 = np.concatenate(acc_xy1)
    w = np.concatenate(acc_w)
    if xy0.shape[0] < 3:
        return None
    if settings.get('refine_subpixel', True):
        sigma = (settings.get('detect_settings', {}) or {}).get('sigma', 3.5)
        # on the device the feature stage ran on, where its descriptors
        # stay; on the host for keypoints carried in without them
        xy0 = refine_matches_subpixel(
            img0, img1, xy0, xy1, sigma=sigma,
            device=kp0.des_dev.device if use_masked else None)
    trace.count('thumbnail.coarse_matches', xy0.shape[0])
    return Match(xy0, xy1, w, config.DEFAULT_AVG_DEFORM)


@trace.spanned('thumbnail.refine')
def match_two_thumbnails_pmcc(img0, img1, mask0=None, mask1=None,
                              initial_match=None, device=None, **settings):
    """Mesh-based block refinement of a coarse match
    (reference: thumbnail.py:490)."""
    from feabas_tpu_torch.dal import StreamLoader
    from feabas_tpu_torch.matcher import section_matcher
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.optimizer import SLM
    h0, w0 = np.asarray(img0).shape[:2]
    h1, w1 = np.asarray(img1).shape[:2]
    mesh_size = settings.get('mesh_size', max(min(h0, w0) / 6.0, 20))
    mesh0 = Mesh.from_bbox((0, 0, w0, h0), cartesian=True,
                           mesh_size=mesh_size, uid=0, locked=True)
    mesh1 = Mesh.from_bbox((0, 0, w1, h1), cartesian=True,
                           mesh_size=mesh_size, uid=1)
    if initial_match is not None and initial_match.xy0.shape[0] >= 3:
        slm = SLM([mesh0, mesh1], device=device)
        slm.add_link_from_coordinates(0, 1, initial_match.xy0,
                                      initial_match.xy1,
                                      weight=initial_match.weight)
        slm.optimize_affine_cascade(start_gear=const.MESH_GEAR_INITIAL)
    block = dict(settings.get('block_matching', {}) or {})
    block.setdefault('spacings', [150, 50])
    block.setdefault('sigma', 3.5)
    match = section_matcher(mesh0, mesh1, StreamLoader(np.asarray(img0)),
                           StreamLoader(np.asarray(img1)), device=device,
                           **{k: v for k, v in block.items()
                              if k in ('spacings', 'sigma', 'conf_thresh',
                                       'pad', 'residue_mode', 'residue_len',
                                       'min_boundary_distance', 'batch_size',
                                       'shrink_factor', 'distributor',
                                       'geodesic_mask', 'allow_dwell',
                                       'max_spacing_skip', 'link_weight_decay',
                                       'min_block_size_multiplier',
                                       'split_disconnected',
                                       'render_weight_threshold',
                                       'stiffness_multiplier_threshold',
                                       'envelope_normalize',
                                       'subpixel_upsample')})
    if match is not None:
        trace.count('thumbnail.refined_matches', match.xy0.shape[0])
    return match


def align_two_thumbnails(img0, img1, mask0=None, mask1=None,
                         return_coarse=False, device=None, **settings):
    """Full coarse alignment of a section pair: feature (or template)
    stage, then PMCC refinement (reference: thumbnail.py:529).
    Returns a ``common.Match`` or None; with ``return_coarse`` returns
    (refined, coarse) so drivers can archive the feature-stage matches
    (reference save_feature_match: thumbnail_main.py)."""
    mode = settings.get('match_mode', 'feature')
    if mode == 'feature':
        coarse = match_two_thumbnails_LRadon(
            img0, img1, mask0=mask0, mask1=mask1, device=device,
            **dict(settings.get('feature_matching', {}) or {}))
    else:
        from feabas_tpu_torch.matcher import global_translation_matcher
        dx, dy, cf = global_translation_matcher(
            np.asarray(img0, np.float32), np.asarray(img1, np.float32),
            device=device, sigma=settings.get('sigma', 3.5))
        if cf < settings.get('conf_thresh', 0.3):
            coarse = None
        else:
            h0, w0 = np.asarray(img0).shape[:2]
            h1, w1 = np.asarray(img1).shape[:2]
            c0 = np.array([w0 / 2, h0 / 2])
            c1 = np.array([w1 / 2, h1 / 2])
            t = c0 - c1 - np.array([dx, dy])
            pts1 = np.stack(np.meshgrid(np.linspace(0, w1, 4),
                                        np.linspace(0, h1, 4)), -1).reshape(-1, 2)
            coarse = Match(pts1 + t, pts1, np.full(pts1.shape[0], cf),
                           config.DEFAULT_AVG_DEFORM)
    if coarse is None:
        return (None, None) if return_coarse else None
    refined = match_two_thumbnails_pmcc(img0, img1, mask0=mask0, mask1=mask1,
                                        initial_match=coarse, device=device,
                                        **settings)
    out = refined if refined is not None else coarse
    return (out, coarse) if return_coarse else out
