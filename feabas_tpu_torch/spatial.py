"""Host-plane vector geometry: transform fitting, mask-backed region
geometry, PSLG generation, and grid point generators.

Replaces the reference's shapely/GEOS layer (``feabas/spatial.py``) with a
mask-backed design: regions originate from label masks, contours are
extracted and simplified with cv2, and material membership of any point is
answered by sampling the mask — no boolean polygon algebra needed.

The port's copy of ``feabas_tpu/spatial.py``, cut to what the port reaches.
"""

import cv2
import numpy as np

from feabas_tpu_torch.common import imread


# ------------------------- transform fitting ------------------------- #

def fit_affine(pts0, pts1, weights=None, return_rigid=False, avoid_flip=True):
    """Weighted least-squares affine mapping pts1 -> pts0.

    Returns a 3x3 row-vector transform T ([x, y, 1] @ T ~ [x', y', 1]),
    optionally alongside its closest rigid transform (rotation+translation
    via weighted Procrustes). Degenerate inputs (rank-deficient, < 3 points)
    fall back to rigid/translation fits; reflections are suppressed when
    ``avoid_flip`` (capability parity: reference feabas/spatial.py:21).
    """
    pts0 = np.asarray(pts0, dtype=np.float64).reshape(-1, 2)
    pts1 = np.asarray(pts1, dtype=np.float64).reshape(-1, 2)
    n = pts0.shape[0]
    if weights is None:
        w = np.ones(n)
    else:
        w = np.clip(np.asarray(weights, dtype=np.float64).ravel(), 0, None)
        if w.sum() == 0:
            w = np.ones(n)
    wsum = w.sum()
    c0 = (pts0 * w[:, None]).sum(0) / wsum
    c1 = (pts1 * w[:, None]).sum(0) / wsum
    q0 = pts0 - c0
    q1 = pts1 - c1
    # weighted Procrustes rotation (always computable)
    H = (q1 * w[:, None]).T @ q0
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(2)
    if np.linalg.det(U @ Vt) < 0:
        S[1, 1] = -1
    R = U @ S @ Vt
    T_rigid = np.eye(3)
    T_rigid[:2, :2] = R
    T_rigid[2, :2] = c0 - c1 @ R

    # full affine via weighted normal equations; fall back on deficiency
    A = None
    if n >= 3:
        M = (q1 * w[:, None]).T @ q1
        if np.linalg.matrix_rank(M) == 2 and np.linalg.cond(M) < 1e8:
            A = np.linalg.solve(M, (q1 * w[:, None]).T @ q0)
    if A is None or (avoid_flip and np.linalg.det(A) <= 0):
        T = T_rigid.copy()
    else:
        T = np.eye(3)
        T[:2, :2] = A
        T[2, :2] = c0 - c1 @ A
    if return_rigid:
        return T, T_rigid
    return T


def apply_affine(pts, T):
    pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
    return pts @ T[:2, :2] + T[2, :2]


def find_rotation_for_minimum_rectangle(pts):
    """Rotation angle (radians) that minimizes the bounding rectangle of a
    point set (reference: feabas/spatial.py:525)."""
    pts = np.asarray(pts, dtype=np.float32).reshape(-1, 2)
    if pts.shape[0] < 3:
        return 0.0
    rect = cv2.minAreaRect(pts)
    theta = np.deg2rad(rect[2])
    # normalize to smallest-magnitude equivalent rotation
    theta = (theta + np.pi / 4) % (np.pi / 2) - np.pi / 4
    return float(theta)


# ------------------------- grids ------------------------- #

def generate_equilat_grid_bbox(bbox, side_len):
    """Equilateral-triangle lattice covering bbox (with margin)."""
    xmin, ymin, xmax, ymax = bbox
    dy = side_len * np.sin(np.pi / 3)
    ny = int(np.ceil((ymax - ymin) / dy)) + 2
    nx = int(np.ceil((xmax - xmin) / side_len)) + 3
    ys = ymin - dy + np.arange(ny + 1) * dy
    pts = []
    for r, y in enumerate(ys):
        x0 = xmin - side_len + (side_len / 2 if r % 2 else 0)
        xs = x0 + np.arange(nx + 1) * side_len
        pts.append(np.stack([xs, np.full_like(xs, y)], axis=-1))
    return np.concatenate(pts, axis=0)


# ------------------------- mask <-> contours ------------------------- #

def _offset_ring(ring, delta, grow=True):
    """Offset a closed polygon ring by ``delta`` px (miter joins), in the
    direction that grows (or shrinks) its enclosed area.

    cv2 contours pass through boundary-PIXEL CENTERS, half a pixel
    inside the true region extent; offsetting the raw rectilinear ring
    outward by 0.5 recovers the pixel-border boundary exactly (all
    corners are right angles, where the miter join is exact). The
    reference applies the same correction with a shapely buffer
    ("expand by half pixel", feabas/spatial.py:138)."""
    d = np.roll(ring, -1, axis=0) - ring
    L = np.linalg.norm(d, axis=1, keepdims=True)
    L[L == 0] = 1.0
    dn = d / L
    n = np.stack([dn[:, 1], -dn[:, 0]], axis=-1)
    n_in = np.roll(n, 1, axis=0)
    # miter: vertex moves along the normal bisector so both adjacent
    # edges shift by exactly delta; clamp the denominator so 1-px-wide
    # out-and-back spikes (180-degree turns) stay finite
    denom = np.maximum(1.0 + (dn * np.roll(dn, 1, axis=0)).sum(axis=1),
                       0.5)[:, None]
    for sign in (delta, -delta):
        cand = ring + sign * (n + n_in) / denom
        if (ring_area(cand) >= ring_area(ring)) == bool(grow):
            return cand
    return cand


def mask_to_contours(mask, simplify_tol=2.0, zigzag_tol=0.5,
                     border_offset=0.5):
    """Extract (outer, holes) contour rings from a boolean mask.

    Returns list of (ring, is_hole) where ring is (K,2) float64 in pixel
    coordinates: cv2 center-convention contours expanded by
    ``border_offset`` to the true pixel-border extent (region pixels own
    [c-0.5, c+0.5]; holes shrink), staircase-smoothed at ``zigzag_tol``
    then simplified with Douglas-Peucker at ``simplify_tol``.
    """
    m = (np.asarray(mask) > 0).astype(np.uint8)
    contours, hierarchy = cv2.findContours(m, cv2.RETR_CCOMP, cv2.CHAIN_APPROX_SIMPLE)
    rings = []
    if hierarchy is None:
        return rings
    for c, h in zip(contours, hierarchy[0]):
        ring = c.reshape(-1, 2).astype(np.float64)
        if border_offset and ring.shape[0] >= 3:
            ring = _offset_ring(ring, border_offset, grow=h[3] < 0)
        if zigzag_tol and zigzag_tol > 0 and ring.shape[0] > 3:
            ring = smooth_zigzag(ring, tol=zigzag_tol, closed=True)
        if simplify_tol > 0 and ring.shape[0] > 3:
            ring = cv2.approxPolyDP(ring.astype(np.float32),
                                    float(simplify_tol),
                                    closed=True).reshape(-1, 2)
            ring = ring.astype(np.float64)
        if ring.shape[0] < 3:
            continue
        is_hole = h[3] >= 0
        rings.append((ring, is_hole))
    return rings


def douglas_peucker(pts, tol):
    """Simplify an open polyline, keeping endpoints (iterative DP)."""
    pts = np.asarray(pts, np.float64)
    n = pts.shape[0]
    if n <= 2 or tol <= 0:
        return pts
    keep = np.zeros(n, bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        i0, i1 = stack.pop()
        if i1 <= i0 + 1:
            continue
        p0, p1 = pts[i0], pts[i1]
        seg = p1 - p0
        L = np.hypot(*seg)
        mid = pts[i0 + 1:i1]
        if L < 1e-12:
            d = np.linalg.norm(mid - p0, axis=1)
        else:
            d = np.abs(seg[0] * (mid[:, 1] - p0[1])
                       - seg[1] * (mid[:, 0] - p0[0])) / L
        k = int(np.argmax(d))
        if d[k] > tol:
            j = i0 + 1 + k
            keep[j] = True
            stack.append((i0, j))
            stack.append((j, i1))
    return pts[keep]


def _point_chord_dist(v, a, b):
    """Distance of points v to the (infinite) chords a->b, elementwise."""
    seg = b - a
    L = np.hypot(seg[:, 0], seg[:, 1])
    d = np.abs(seg[:, 0] * (v[:, 1] - a[:, 1])
               - seg[:, 1] * (v[:, 0] - a[:, 0]))
    near = L < 1e-12
    out = np.where(near, np.linalg.norm(v - a, axis=1),
                   d / np.maximum(L, 1e-12))
    return out


def smooth_zigzag(pts, tol=0.5, closed=False):
    """Bitmap staircase anti-aliasing (reference smooth_zigzag role,
    feabas/spatial.py:342-395): rebuild the polyline from its segment
    midpoints, keeping only original vertices that deviate >= ``tol``
    from the midpoint chain (true corners). Staircase corners from mask
    rasterization sit ~0.35-0.5 px from the midpoint chain, so the
    smoothed line runs through the stair midpoints — the unbiased
    estimate of the underlying boundary — instead of the pixel corners.
    Open polylines keep their endpoints (arc junctions stay shared)."""
    pts = np.asarray(pts, np.float64)
    if tol <= 0 or pts.shape[0] < 3:
        return pts
    dup_end = closed and bool(np.all(pts[0] == pts[-1]))
    # collapse collinear runs first (reference: simplify(1e-3*tol) before
    # the midpoint pass) so true corners get LONG adjacent segments and
    # survive the midpoint criterion; staircase jogs are never collinear
    # and stay for smoothing
    core = pts[:-1] if dup_end else pts
    if core.shape[0] > 2:
        prev = np.roll(core, 1, axis=0)
        nxt = np.roll(core, -1, axis=0)
        dev = _point_chord_dist(core, prev, nxt)
        keep = dev >= 1e-3 * tol
        if not closed:
            keep[0] = keep[-1] = True
        if keep.sum() >= (3 if closed else 2):
            core = core[keep]
    pts = (np.concatenate([core, core[:1]], axis=0) if dup_end else core)
    n = pts.shape[0]
    if n < 3:
        return pts
    if closed:
        r = pts[:-1] if dup_end else pts
        if r.shape[0] < 3:
            return pts
        mids = (r + np.roll(r, -1, axis=0)) / 2
        keep = _point_chord_dist(r, np.roll(mids, 1, axis=0), mids) >= tol
        out = []
        for i in range(r.shape[0]):
            if keep[i]:
                out.append(r[i])
            out.append(mids[i])
        out = np.asarray(out)
        if dup_end:
            out = np.concatenate([out, out[:1]], axis=0)
        return out
    mids = (pts[:-1] + pts[1:]) / 2
    keep = _point_chord_dist(pts[1:-1], mids[:-1], mids[1:]) >= tol
    out = [pts[0]]
    for i in range(1, n - 1):
        out.append(mids[i - 1])
        if keep[i - 1]:
            out.append(pts[i])
    out.append(mids[-1])
    out.append(pts[-1])
    return np.asarray(out)


def label_boundary_arcs(label_mask, outside_label=-1):
    """Decompose a label map's region boundaries into a SHARED arc graph.

    Nodes sit at junction corners (where >= 3 labels meet or boundary
    valence != 2); each arc is an open polyline between nodes (or a
    closed loop) separating exactly TWO labels. Simplifying each arc once
    keeps adjacent regions' boundaries identical — the topology-sharing
    role of the reference's polygon simplification
    (reference: feabas/spatial.py:900-1260).

    Returns a list of dicts: {'pts': (K,2) float64 in pixel-CENTER
    coordinates (cv2 contour convention), 'labels': (left, right),
    'closed': bool}.
    """
    lm = np.asarray(label_mask)
    H, W = lm.shape
    pad = np.full((H + 2, W + 2), outside_label, np.int64)
    pad[1:-1, 1:-1] = lm
    CW = W + 3                                     # corner lattice stride
    # horizontal edges at y=i+1 spanning x in [c, c+1]
    dh = pad[1:, :] != pad[:-1, :]                 # (H+1, W+2)
    hi, hc = np.nonzero(dh)
    # vertical edges at x=j+1 spanning y in [r, r+1]
    dv = pad[:, 1:] != pad[:, :-1]                 # (H+2, W+1)
    vr, vj = np.nonzero(dv)
    # edge table: (corner_a, corner_b, left_label, right_label) with the
    # left/right convention relative to a->b traversal
    ea = np.concatenate([(hi + 1) * CW + hc, vr * CW + (vj + 1)])
    eb = np.concatenate([(hi + 1) * CW + hc + 1, (vr + 1) * CW + (vj + 1)])
    # horizontal a->b goes +x: left = above = pad[i, c], right = below
    # vertical a->b goes +y: left = right-side = pad[r, j+1]? traversal +y
    # has +x on the LEFT when y grows downward... use the image convention
    # (y down): traveling +x, "left" is smaller y (above).
    el = np.concatenate([pad[hi, hc], pad[vr, vj + 1]])
    er = np.concatenate([pad[hi + 1, hc], pad[vr, vj]])
    nE = ea.shape[0]
    if nE == 0:
        return []
    deg = np.bincount(np.concatenate([ea, eb]), minlength=(H + 3) * CW)
    # corner -> incident edge lists
    inc = {}
    for k in range(nE):
        inc.setdefault(ea[k], []).append(k)
        inc.setdefault(eb[k], []).append(k)
    visited = np.zeros(nE, bool)

    def corner_xy(cid):
        return np.array([cid % CW - 1.5, cid // CW - 1.5])

    def walk(start_edge, start_corner):
        """Follow the chain from start_corner through start_edge until a
        junction (or loop closure). Returns (corner ids, labels)."""
        k = start_edge
        c = start_corner
        visited[k] = True
        nxt = eb[k] if ea[k] == c else ea[k]
        # labels oriented in traversal direction
        if ea[k] == c:
            lab = (el[k], er[k])
        else:
            lab = (er[k], el[k])
        chain = [c, nxt]
        while deg[nxt] == 2 and nxt != start_corner:
            cand = [e for e in inc[nxt] if not visited[e]]
            if not cand:
                break
            k = cand[0]
            visited[k] = True
            c = nxt
            nxt = eb[k] if ea[k] == c else ea[k]
            chain.append(nxt)
        return chain, lab

    arcs = []
    junctions = np.nonzero(deg[:np.concatenate([ea, eb]).max() + 1] > 0)[0]
    junctions = junctions[deg[junctions] != 2]
    for c in junctions:
        for k in list(inc.get(int(c), [])):
            if visited[k]:
                continue
            chain, lab = walk(k, int(c))
            pts = np.stack([corner_xy(x) for x in chain])
            arcs.append({'pts': pts, 'labels': lab, 'closed': False})
    # leftover degree-2 loops
    for k in range(nE):
        if visited[k]:
            continue
        chain, lab = walk(k, int(ea[k]))
        pts = np.stack([corner_xy(x) for x in chain])
        arcs.append({'pts': pts, 'labels': lab, 'closed': True})
    return arcs


def simplify_arcs(arcs, tol, default_tol=0.1, zigzag_tol=0.5):
    """Douglas-Peucker each arc ONCE (endpoints pinned, so the junction
    topology and the adjacency between regions survive simplification).
    Closed loops split at their farthest point so they keep shape.

    ``tol`` is a scalar, or a dict mapping mask labels (int) to per-region
    tolerances (missing labels get ``default_tol``); an arc separates two
    regions, so its tolerance is the MIN of the two sides — the per-region
    tolerance role of the reference's ``simplify_by_segments``
    (feabas/spatial.py:900-1030). Arcs are staircase-smoothed at
    ``zigzag_tol`` first (reference: spatial.py:986) so the simplified
    line tracks the unbiased boundary instead of the pixel corners."""
    per_label = isinstance(tol, dict)
    out = []
    for a in arcs:
        if per_label:
            t = min(float(tol.get(int(lb), default_tol))
                    for lb in a['labels'])
        else:
            t = float(tol)
        pts = a['pts']
        if zigzag_tol and zigzag_tol > 0:
            pts = smooth_zigzag(pts, tol=zigzag_tol, closed=a['closed'])
        if a['closed'] and pts.shape[0] > 3:
            d = np.linalg.norm(pts - pts[0], axis=1)
            m = int(np.argmax(d))
            if m > 0:
                s0 = douglas_peucker(pts[:m + 1], t)
                s1 = douglas_peucker(pts[m:], t)
                pts = np.concatenate([s0[:-1], s1], axis=0)
        else:
            pts = douglas_peucker(pts, t)
        if pts.shape[0] >= 2:
            out.append({**a, 'pts': pts})
    return out


def ring_area(ring):
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def resample_ring(ring, spacing):
    """Insert vertices so no segment is longer than ``spacing`` (keeps the
    original corners)."""
    out = []
    n = ring.shape[0]
    for i in range(n):
        p0, p1 = ring[i], ring[(i + 1) % n]
        seg = p1 - p0
        d = np.hypot(*seg)
        k = max(int(np.ceil(d / spacing)), 1)
        for t in range(k):
            out.append(p0 + seg * (t / k))
    return np.asarray(out)


class Geometry:
    """Region geometry of one section: a label mask + material table mapping.

    The mask is the source of truth; simplified contours derive the PSLG for
    meshing, and material membership queries sample the mask (reference
    counterpart builds shapely polygon sets: feabas/spatial.py:561-1269).

    Attributes:
        label_mask: (H,W) integer mask of material labels.
        offset: world coordinates of pixel (0,0).
        scale: world units per mask pixel.
    """

    def __init__(self, label_mask, material_table=None, offset=(0, 0),
                 scale=1.0, resolution=None, roi_erosion=0.0, dilate=0.0,
                 oor_label=None):
        self.label_mask = np.array(label_mask)
        if self.label_mask.ndim == 3:
            self.label_mask = self.label_mask[..., 0]
        self.offset = np.asarray(offset, dtype=np.float64)
        self.scale = float(scale)
        self.resolution = resolution
        if material_table is None:
            from feabas_tpu_torch.config import material_table as default_table
            material_table = default_table()
        self.material_table = material_table
        if oor_label is not None:
            # out-of-roi label folds into exclude (reference oor_label,
            # feabas/spatial.py:606)
            self.label_mask[self.label_mask == oor_label] = self.exclude_label
        if dilate and dilate > 0:
            self._dilate_regions(dilate)
        if roi_erosion and roi_erosion > 0:
            self._erode_roi(roi_erosion)

    @classmethod
    def from_image(cls, path, material_table=None, **kwargs):
        mask = imread(path, flag=cv2.IMREAD_GRAYSCALE)
        return cls(mask, material_table=material_table, **kwargs)

    @property
    def exclude_label(self):
        try:
            return self.material_table['exclude'].mask_label
        except KeyError:
            return 255

    def roi_mask(self):
        return self.label_mask != self.exclude_label

    def label_at(self, pts):
        """Material mask label at world points (nearest pixel; outside -> exclude)."""
        pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
        cc = np.round((pts[:, 0] - self.offset[0]) / self.scale).astype(np.int64)
        rr = np.round((pts[:, 1] - self.offset[1]) / self.scale).astype(np.int64)
        h, w = self.label_mask.shape
        out = np.full(pts.shape[0], self.exclude_label,
                      dtype=self.label_mask.dtype)
        ok = (cc >= 0) & (cc < w) & (rr >= 0) & (rr < h)
        out[ok] = self.label_mask[rr[ok], cc[ok]]
        return out

    def bbox(self):
        h, w = self.label_mask.shape
        return (self.offset[0], self.offset[1],
                self.offset[0] + w * self.scale, self.offset[1] + h * self.scale)

    # ---------------- mutation / persistence / comparison ------------- #
    # Mask-backed equivalents of the reference Geometry's polygon API
    # (feabas/spatial.py:642-863): the label mask is the source of truth,
    # so region algebra is pixel paint with latest-wins z-order, and
    # buffering is morphology. All distances/areas are WORLD units.

    @property
    def default_label(self):
        try:
            lb = self.material_table['default'].mask_label
        except KeyError:
            lb = 0
        return 0 if lb is None else int(lb)

    def _kernel(self, dist):
        k = int(round(float(dist) / self.scale))
        if k < 1:
            return None
        return cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * k + 1,) * 2)

    def _dilate_regions(self, dist):
        """Grow every non-default, non-exclude region by ``dist`` world
        units (reference ``dilate`` kwarg, feabas/spatial.py:633-637)."""
        ker = self._kernel(dist)
        if ker is None:
            return
        ex, de = self.exclude_label, self.default_label
        for lb in np.unique(self.label_mask):
            if lb in (ex, de):
                continue
            m = (self.label_mask == lb).astype(np.uint8)
            grown = cv2.dilate(m, ker) > 0
            # growth only claims default pixels: exclude stays out-of-roi
            # and later-painted regions keep their z-order
            self.label_mask[grown & (self.label_mask == de)] = lb

    def _erode_roi(self, dist):
        """Shrink the ROI inward by ``dist`` world units (reference
        ``roi_erosion``, feabas/spatial.py:629-631)."""
        ker = self._kernel(dist)
        if ker is None:
            return
        roi = (self.label_mask != self.exclude_label).astype(np.uint8)
        eroded = cv2.erode(roi, ker, borderType=cv2.BORDER_CONSTANT,
                           borderValue=0) > 0
        self.label_mask[~eroded] = self.exclude_label

    def save_to_h5(self, path):
        """Persist mask + grid + name->label LUT (role of reference
        Geometry.save_to_h5, feabas/spatial.py:660; stores the raster
        source of truth instead of polygon WKBs)."""
        from feabas_tpu_torch.storage import H5File
        names, labels = [], []
        for name, mat in self.material_table:
            if mat.mask_label is not None:
                names.append(name)
                labels.append(int(mat.mask_label))
        with H5File(path, 'w') as f:
            f.create_dataset('label_mask', data=self.label_mask,
                             compression='gzip')
            f.create_dataset('offset', data=self.offset)
            f.create_dataset('scale', data=self.scale)
            if self.resolution is not None:
                f.create_dataset('resolution', data=float(self.resolution))
            f.create_dataset('label_names',
                             data='\n'.join(names).encode('ascii'))
            f.create_dataset('label_values',
                             data=np.asarray(labels, np.int64))

    @classmethod
    def from_h5(cls, path, material_table=None):
        """Load a Geometry saved by :meth:`save_to_h5` (reference
        Geometry.from_h5, feabas/spatial.py:642). The file's stored
        name->label LUT is AUTHORITATIVE: if it disagrees with (or names
        materials missing from) the supplied/default table, the table is
        cloned and patched, so a geometry saved under a custom material
        table round-trips without the caller re-supplying it."""
        from feabas_tpu_torch.storage import H5File
        stored = []
        with H5File(path, 'r') as f:
            mask = f['label_mask'][()]
            offset = f['offset'][()]
            scale = float(f['scale'][()])
            resolution = (float(f['resolution'][()])
                          if 'resolution' in f else None)
            if 'label_names' in f and 'label_values' in f:
                raw = f['label_names'][()]
                names = (raw.decode('ascii') if isinstance(raw, bytes)
                         else str(raw)).split('\n')
                vals = np.asarray(f['label_values'][()], np.int64)
                stored = [(n, int(v)) for n, v in zip(names, vals) if n]
        if material_table is None:
            from feabas_tpu_torch.config import material_table as default_table
            material_table = default_table()
        if stored and any(
                (n not in material_table)
                or material_table[n].mask_label != lb for n, lb in stored):
            from feabas_tpu_torch.material import Material
            material_table = material_table.copy()
            for n, lb in stored:
                if n in material_table:
                    material_table[n].mask_label = lb
                else:
                    material_table.add(n, Material(mask_label=lb))
        return cls(mask, material_table=material_table, offset=offset,
                   scale=scale, resolution=resolution)

    def commit(self, area_thresh=0):
        """Rectify the mask: drop sub-threshold connected components
        (reference commit + polygon_area_filter, feabas/spatial.py:759-810).
        Small non-default region islands revert to the default material;
        small disconnected ROI islands become exclude. Interior holes are
        already exclude pixels in the raster representation. ``area_thresh``
        is in world units squared. Returns self."""
        if area_thresh and area_thresh > 0:
            min_px = float(area_thresh) / (self.scale ** 2)
            ex, de = self.exclude_label, self.default_label
            for lb in np.unique(self.label_mask):
                if lb in (ex, de):
                    continue
                m = (self.label_mask == lb).astype(np.uint8)
                n, comp, stats, _ = cv2.connectedComponentsWithStats(m)
                for k in range(1, n):
                    if stats[k, cv2.CC_STAT_AREA] < min_px:
                        self.label_mask[comp == k] = de
            roi = (self.label_mask != ex).astype(np.uint8)
            n, comp, stats, _ = cv2.connectedComponentsWithStats(roi)
            for k in range(1, n):
                if stats[k, cv2.CC_STAT_AREA] < min_px:
                    self.label_mask[comp == k] = ex
        return self

    def compare(self, other):
        """Per-material IOU between two geometries (reference compare,
        feabas/spatial.py:835-862). ``other`` resamples onto this grid by
        nearest neighbor if the grids differ."""
        om = other.label_mask
        if (om.shape != self.label_mask.shape or other.scale != self.scale
                or np.any(other.offset != self.offset)):
            # the self-pixel -> other-pixel map is a separable affine:
            # two 1-D index vectors instead of an (H*W,2) float64 point
            # cloud (which is gigabytes at section-mask scale)
            h, w = self.label_mask.shape
            oh, ow = om.shape
            ci = np.round((np.arange(w) * self.scale + self.offset[0]
                           - other.offset[0]) / other.scale).astype(np.int64)
            ri = np.round((np.arange(h) * self.scale + self.offset[1]
                           - other.offset[1]) / other.scale).astype(np.int64)
            ok_c = (ci >= 0) & (ci < ow)
            ok_r = (ri >= 0) & (ri < oh)
            res = np.full((h, w), other.exclude_label, dtype=om.dtype)
            res[np.ix_(ok_r, ok_c)] = om[np.ix_(ri[ok_r], ci[ok_c])]
            om = res
        ious = {}
        lut = {m.mask_label: n for n, m in self.material_table
               if m.mask_label is not None}
        labels = set(np.unique(self.label_mask)) | set(np.unique(om))
        labels.discard(self.exclude_label)
        for lb in labels:
            a = self.label_mask == lb
            b = om == lb
            union = (a | b).sum()
            name = lut.get(int(lb), f'label{int(lb)}')
            ious[name] = float((a & b).sum() / union) if union else 0.0
        return ious

    def boundary_arcs(self, simplify_tol=2.0, roi_tol=None):
        """Topology-shared boundary arcs in WORLD coordinates: every
        region boundary (outer ROI and internal material-material
        borders) as polylines simplified once per shared arc, so adjacent
        regions keep identical borders (reference's topology-sharing
        simplification, feabas/spatial.py:900-1260).

        ``simplify_tol`` is a scalar, or a dict mapping MATERIAL NAMES to
        per-region tolerances (reference ``region_tols``,
        feabas/mesh.py:3394-3400; unnamed materials default to 0.1 px so
        special regions keep tight boundaries). ``roi_tol`` overrides the
        tolerance of arcs against the exclude/outside region."""
        arcs = label_boundary_arcs(self.label_mask,
                                   outside_label=int(self.exclude_label))
        if isinstance(simplify_tol, dict) or roi_tol is not None:
            if isinstance(simplify_tol, dict):
                default_tol = float(simplify_tol.get('default', 0.1))
                lut = {}
                for name, t in simplify_tol.items():
                    try:
                        lb = self.material_table[name].mask_label
                    except KeyError:
                        continue
                    if lb is not None:
                        lut[int(lb)] = float(t)
            else:
                default_tol = float(simplify_tol)
                lut = {}
            rt = default_tol if roi_tol is None else float(roi_tol)
            # arcs against the outside/exclude region are ROI boundary
            lut[int(self.exclude_label)] = rt
            lut[-1] = rt
            if roi_tol is not None:
                # an EXPLICIT roi_tol overrides in both directions: the
                # min-of-both-sides rule would let a tight material tol
                # silently veto a requested coarse ROI simplification
                roi_lbs = {int(self.exclude_label), -1}
                is_roi = [bool(roi_lbs.intersection(int(lb)
                                                    for lb in a['labels']))
                          for a in arcs]
                roi = [a for a, r in zip(arcs, is_roi) if r]
                inner = [a for a, r in zip(arcs, is_roi) if not r]
                arcs = (simplify_arcs(roi, float(roi_tol))
                        + simplify_arcs(inner, lut, default_tol=default_tol))
            else:
                arcs = simplify_arcs(arcs, lut, default_tol=default_tol)
        else:
            arcs = simplify_arcs(arcs, simplify_tol)
        out = []
        for a in arcs:
            out.append({**a, 'pts': a['pts'] * self.scale + self.offset})
        return out

    def PSLG(self, simplify_tol=2.0, area_thresh=0):
        """Planar straight-line graph of the ROI boundary (world coords).

        ``simplify_tol`` may be the same {material name: tol} dict the
        other boundary methods accept; the ROI outline uses its
        'default' entry. Returns dict with 'vertices' (N,2),
        'segments' (S,2) vertex-index pairs, suitable for conforming
        triangulation (reference: feabas/spatial.py:1270)."""
        if isinstance(simplify_tol, dict):
            simplify_tol = float(simplify_tol.get('default', 2.0))
        rings = mask_to_contours(self.roi_mask(), simplify_tol=simplify_tol)
        vertices = []
        segments = []
        for ring, _is_hole in rings:
            if area_thresh > 0 and ring_area(ring) * self.scale ** 2 < area_thresh:
                continue
            base = sum(len(v) for v in vertices)
            ring_w = ring * self.scale + self.offset
            vertices.append(ring_w)
            n = ring_w.shape[0]
            seg = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=-1) + base
            segments.append(seg)
        if not vertices:
            return {'vertices': np.zeros((0, 2)), 'segments': np.zeros((0, 2), int)}
        return {'vertices': np.concatenate(vertices, axis=0),
                'segments': np.concatenate(segments, axis=0)}


