"""Host-side triangular mesh generation.

Replaces the Shewchuk `triangle` library dependency (reference drives it at
``feabas/mesh.py:296-385``) with a Delaunay-based generator built on
scipy.spatial.Qhull:

- boundary rings are resampled at the target edge length,
- interior points come from an equilateral lattice clipped to the region
  and pushed away from the boundary,
- Delaunay triangulates the point set,
- triangles are kept if their centroid lies inside the region (sampled
  from the generating mask), which handles holes and concavities.

For the masks this pipeline sees (EM section ROIs at thumbnail resolution)
this yields boundary-conforming, well-shaped meshes; per-material area
constraints are honored by meshing each material at its own density and
assigning materials by centroid label.

The port's copy of ``feabas_tpu/triangulation.py``, cut to what the port reaches.
"""

import numpy as np
from scipy.spatial import Delaunay, cKDTree

from feabas_tpu_torch import spatial as sp


def _dedupe(points, tol, return_map=False):
    """Merge points closer than tol (keeps first occurrence). With
    ``return_map`` also returns old-index -> new-index (merged points map
    to their survivor)."""
    if points.shape[0] == 0:
        return (points, np.zeros(0, np.int64)) if return_map else points
    tree = cKDTree(points)
    pairs = tree.query_pairs(tol, output_type='ndarray')
    keep = np.ones(points.shape[0], dtype=bool)
    alias = np.arange(points.shape[0])
    for i, j in pairs[np.argsort(pairs[:, 1])] if pairs.size else []:
        i, j = int(min(i, j)), int(max(i, j))
        if keep[i] and keep[j]:
            keep[j] = False
            alias[j] = i
    if not return_map:
        return points[keep]
    new_index = np.cumsum(keep) - 1
    # chase aliases one level (first occurrences always survive)
    idx_map = new_index[alias]
    return points[keep], idx_map


def _min_angles_deg(pts, T):
    """Per-triangle minimum interior angle (degrees)."""
    p = pts[T]
    angs = []
    for k in range(3):
        a = p[:, (k + 1) % 3] - p[:, k]
        b = p[:, (k + 2) % 3] - p[:, k]
        cosv = (a * b).sum(-1) / np.clip(
            np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12, None)
        angs.append(np.degrees(np.arccos(np.clip(cosv, -1, 1))))
    return np.min(np.stack(angs, -1), axis=-1)


def _min_seg_len(pts, segs):
    """Shortest non-degenerate PSLG segment length (inf when no segments)."""
    if segs.shape[0] == 0 or pts.shape[0] == 0:
        return np.inf
    d = np.linalg.norm(pts[segs[:, 0]] - pts[segs[:, 1]], axis=1)
    d = d[d > 1e-9]
    return float(d.min()) if d.size else np.inf


def _resample_path(path, spacing):
    """Insert vertices on an OPEN polyline so no segment exceeds
    ``spacing`` (keeps the original corners and endpoints)."""
    out = []
    for i in range(path.shape[0] - 1):
        p0, p1 = path[i], path[i + 1]
        seg = p1 - p0
        d = np.hypot(*seg)
        k = max(int(np.ceil(d / spacing)), 1)
        for t in range(k):
            out.append(p0 + seg * (t / k))
    out.append(path[-1])
    return np.asarray(out)


def triangulate_mask(inside_fn, boundary_rings, mesh_size, bbox=None,
                     min_edge_ratio=0.25, extra_points=None,
                     min_angle=0.0, constraint_paths=None):
    """Mesh a region given a membership oracle + boundary rings.

    Args:
        inside_fn: (N,2) world pts -> bool mask (region membership).
        boundary_rings: list of (K,2) world-coordinate rings.
        mesh_size: target edge length.
        extra_points: optional (K,2) refinement points (e.g. a denser
            lattice over refine materials) merged into the point set.
        constraint_paths: optional OPEN polylines (e.g. internal
            material-boundary arcs) whose edges are enforced by the CDT,
            so triangles conform to internal region borders.
    Returns:
        (vertices (N,2) float64, triangles (M,3) int32)
    """
    b_pts = []
    ring_segs = []
    offset = 0
    for ring in boundary_rings:
        rp = sp.resample_ring(np.asarray(ring, np.float64), mesh_size)
        k = rp.shape[0]
        if k >= 2:
            idx = np.arange(k) + offset
            ring_segs.append(np.stack([idx, np.roll(idx, -1)], -1))
        b_pts.append(rp)
        offset += k
    for path in (constraint_paths or []):
        rp = _resample_path(np.asarray(path, np.float64), mesh_size)
        k = rp.shape[0]
        if k >= 2:
            idx = np.arange(k) + offset
            ring_segs.append(np.stack([idx[:-1], idx[1:]], -1))
        b_pts.append(rp)
        offset += k
    b_pts = (np.concatenate(b_pts, axis=0) if b_pts
             else np.zeros((0, 2)))
    ring_segs = (np.concatenate(ring_segs, axis=0) if ring_segs
                 else np.zeros((0, 2), np.int64))
    if bbox is None:
        if b_pts.shape[0] == 0:
            raise ValueError('need boundary rings or bbox')
        bbox = (b_pts[:, 0].min(), b_pts[:, 1].min(),
                b_pts[:, 0].max(), b_pts[:, 1].max())
    grid = sp.generate_equilat_grid_bbox(bbox, mesh_size)
    grid = grid[inside_fn(grid)]
    if extra_points is not None and len(extra_points):
        extra = np.asarray(extra_points, np.float64).reshape(-1, 2)
        extra = extra[inside_fn(extra)]
        if extra.shape[0]:
            # refinement points win over the base lattice where they crowd
            tree = cKDTree(extra)
            if grid.shape[0]:
                d, _ = tree.query(grid, k=1)
                grid = grid[d > 0.6 * mesh_size]
            grid = np.concatenate([grid, extra], axis=0)
    if b_pts.shape[0] > 0 and grid.shape[0] > 0:
        # keep lattice points clear of the boundary so Delaunay edges stay
        # well-shaped near it
        tree = cKDTree(b_pts)
        d, _ = tree.query(grid, k=1)
        grid = grid[d > 0.5 * mesh_size]
    # Boundary/constraint vertices are PSLG input: merge only (near-)exact
    # duplicates (shared arc junctions), never thin them against mesh_size —
    # their density is controlled by the simplification tolerance upstream,
    # exactly like the reference's enforced PSLG segments
    # (feabas/mesh.py:296-385). min_edge_ratio still guards ring-resample
    # points crowding each other at corners.
    b_pts2, idx_map = _dedupe(b_pts, min(min_edge_ratio * mesh_size,
                                         _min_seg_len(b_pts, ring_segs) / 2),
                              return_map=True)
    pts = np.concatenate([b_pts2, grid], axis=0)
    if pts.shape[0] < 3:
        raise ValueError('region too small to mesh')
    # TRUE constrained Delaunay when the native helper is available: the
    # boundary-ring edges are enforced as triangulation edges, so the mesh
    # conforms exactly to concavities/holes with no bridging
    T = None
    from feabas_tpu_torch import native
    if ring_segs.shape[0] and native.cdt_available():
        segs = idx_map[ring_segs]
        segs = segs[segs[:, 0] != segs[:, 1]]
        T, n_ok = native.cdt_triangulate(pts, segments=segs)
        if T is not None and n_ok < segs.shape[0]:
            T = None  # degenerate input (vertex on a segment): fall back
    if T is None:
        tri = Delaunay(pts)
        T = tri.simplices.astype(np.int32)
    centroids = pts[T].mean(axis=1)
    keep = inside_fn(centroids)
    # drop slivers: triangles with an edge much longer than mesh_size appear
    # when Delaunay bridges concavities
    e = pts[T] - pts[np.roll(T, 1, axis=1)]
    elen = np.sqrt((e ** 2).sum(-1)).max(axis=1)
    keep &= elen < 2.0 * mesh_size
    # drop (near-)degenerate triangles: three exactly-collinear boundary
    # points (a straight run of a resampled ring/constraint arc) can come
    # out of the CDT as a zero-area "cap" — it has no interior, so
    # removing it never opens a hole, while keeping it blows up the FEM
    # terms that divide by area
    p = pts[T]
    area2 = np.abs((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
                   - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    keep &= area2 > 1e-6 * mesh_size ** 2
    if min_angle and min_angle > 0:
        # honor the meshing min_mesh_angle quality constraint: Delaunay
        # over the lattice only produces bad angles in boundary slivers,
        # so dropping them does not open interior holes
        keep &= _min_angles_deg(pts, T) >= float(min_angle)
    T = T[keep]
    verts, T = compact_vertices(pts, T)
    return verts, T


def compact_vertices(vertices, triangles):
    """Drop unreferenced vertices, remap triangle indices."""
    used = np.unique(triangles)
    remap = np.full(vertices.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    return vertices[used], remap[triangles].astype(np.int32)


def triangulate_geometry(geom, mesh_size, area_thresh=0, simplify_tol=2.0,
                         min_angle=0.0, shared_boundaries=True,
                         roi_tol=None):
    """Mesh a :class:`feabas_tpu_torch.spatial.Geometry` (all mesh-enabled
    materials as one region), assigning per-triangle material uids by
    centroid label. With ``shared_boundaries`` (and the native CDT
    available) the INTERNAL material-material borders enter the
    triangulation as topology-shared simplified arcs, so triangles
    conform exactly to region boundaries instead of material assignment
    quantizing to the mask resolution (reference polygon simplification
    role: spatial.py:900-1260).

    ``simplify_tol`` is a scalar or a {material_name: tol} dict
    (reference region_tols, feabas/mesh.py:3394-3400); ``roi_tol``
    controls the outer-ROI ring simplification (defaults to the scalar
    tol, or the dict's 'default' entry). Returns
    (vertices, triangles, material_uids)."""
    if isinstance(simplify_tol, dict):
        rt = float(simplify_tol.get('default', 2.0)) if roi_tol is None \
            else float(roi_tol)
    else:
        rt = float(simplify_tol) if roi_tol is None else float(roi_tol)
    roi = geom.roi_mask()
    rings = sp.mask_to_contours(roi, simplify_tol=rt)
    world_rings = []
    for ring, is_hole in rings:
        if area_thresh > 0 and sp.ring_area(ring) * geom.scale ** 2 < area_thresh:
            continue
        world_rings.append(ring * geom.scale + geom.offset)
    exclude = geom.exclude_label
    constraint_paths = None
    if shared_boundaries:
        from feabas_tpu_torch import native
        if native.cdt_available():
            # internal borders only: arcs touching the outside/exclude
            # region are already covered by the ROI rings
            ex = int(exclude)
            constraint_paths = [
                a['pts'] for a in geom.boundary_arcs(
                    simplify_tol=simplify_tol, roi_tol=rt)
                if ex not in a['labels'] and -1 not in a['labels']]

    def inside(pts):
        return geom.label_at(pts) != exclude

    # per-material area constraints: materials with area_constraint in
    # (0, 1) get a denser lattice over their labeled region (edge length
    # scales with sqrt(area))
    extra = []
    spacings = []
    for name, mat in geom.material_table:
        af = float(getattr(mat, 'area_constraint', 1.0))
        if not (0 < af < 1) or mat.mask_label is None:
            continue
        dense = sp.generate_equilat_grid_bbox(geom.bbox(),
                                              mesh_size * np.sqrt(af))
        sel = geom.label_at(dense) == int(mat.mask_label)
        if sel.any():
            extra.append(dense[sel])
            spacings.append(mesh_size * np.sqrt(af))
    if len(extra) > 1:
        # lattices of DIFFERENT materials are mutually unaligned: across a
        # shared border two points can land arbitrarily close, surviving
        # into Delaunay as a degenerate triangle. Merge near-duplicates at
        # a fraction of the densest intended spacing (same-lattice points
        # sit at >= min(spacings) and are never touched).
        extra = _dedupe(np.concatenate(extra, axis=0), 0.3 * min(spacings))
    else:
        extra = extra[0] if extra else None
    verts, tris = triangulate_mask(inside, world_rings, mesh_size,
                                   bbox=geom.bbox(), extra_points=extra,
                                   min_angle=min_angle,
                                   constraint_paths=constraint_paths)
    labels = geom.label_at(verts[tris].mean(axis=1))
    lut = {}
    for name, mat in geom.material_table:
        if mat.mask_label is not None:
            lut[int(mat.mask_label)] = mat.uid
    default_uid = geom.material_table['default'].uid
    uids = np.asarray([lut.get(int(lb), default_uid) for lb in labels],
                      dtype=np.int16)
    # drop triangles on non-meshed materials
    mesh_ok = {mat.uid: mat.enable_mesh for _, mat in geom.material_table}
    keep = np.asarray([mesh_ok.get(int(u), True) for u in uids], dtype=bool)
    verts, tris2 = compact_vertices(verts, tris[keep])
    return verts, tris2, uids[keep]


def cartesian_mesh(bbox, mesh_size, max_aspect_ratio=2.0, min_num_blocks=1):
    """Rectangular grid mesh over a bbox, each cell split into two
    triangles with alternating diagonals (keeps deformation isotropy).
    Behavioral counterpart of reference ``Mesh.from_bbox(cartesian=True)``
    (feabas/mesh.py:403)."""
    xmin, ymin, xmax, ymax = bbox
    wd, ht = xmax - xmin, ymax - ymin
    nx = max(int(round(wd / mesh_size)), min_num_blocks)
    ny = max(int(round(ht / mesh_size)), min_num_blocks)
    dx, dy = wd / nx, ht / ny
    if max_aspect_ratio > 1:
        if dx > max_aspect_ratio * dy:
            dx = max_aspect_ratio * dy
            nx = int(np.ceil(wd / dx))
        elif dy > max_aspect_ratio * dx:
            dy = max_aspect_ratio * dx
            ny = int(np.ceil(ht / dy))
    xs = np.linspace(xmin, xmax, nx + 1)
    ys = np.linspace(ymin, ymax, ny + 1)
    vx, vy = np.meshgrid(xs, ys)
    verts = np.stack([vx.ravel(), vy.ravel()], axis=-1)
    idx = np.arange(verts.shape[0]).reshape(ny + 1, nx + 1)
    tris = []
    for j in range(ny):
        for i in range(nx):
            a, b = idx[j, i], idx[j, i + 1]
            c, d = idx[j + 1, i], idx[j + 1, i + 1]
            if (i + j) % 2 == 0:
                tris.append([a, b, d])
                tris.append([a, d, c])
            else:
                tris.append([a, b, c])
                tris.append([b, d, c])
    return verts.astype(np.float64), np.asarray(tris, dtype=np.int32)


def equilateral_bbox_mesh(bbox, mesh_size):
    """Structured staggered near-equilateral lattice over a bbox with
    STRAIGHT boundaries and an explicit triangle table (no Delaunay).

    Rows sit at pitch ``ht/ny`` (ny chosen so mesh_size*sqrt(3)/2 rows
    fit evenly); even rows carry vertices at ``c*a``, odd rows at
    ``(c+0.5)*a`` plus the two boundary verts — every vertex-pair offset
    of every triangle lies in {-1,0,1}^2 of the (row, col) lattice, so
    the FEM stencil matvec applies (fem.lattice_embedding detects it).
    Quality matches the Delaunay equilateral generator away from the
    boundary and beats its sliver-prone boundary fan. (Reference role:
    uniform-bbox section meshing, feabas/mesh.py:441 bd_width=inf.)
    """
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    wd, ht = xmax - xmin, ymax - ymin
    ny = max(int(round(ht / (mesh_size * np.sqrt(3) / 2))), 1)
    nxc = max(int(round(wd / mesh_size)), 1)
    h = ht / ny
    a = wd / nxc
    rows = []
    for r in range(ny + 1):
        y = ymin + r * h
        if r % 2 == 0:
            xs = xmin + a * np.arange(nxc + 1)
        else:
            xs = np.concatenate([[xmin], xmin + a * (np.arange(nxc) + 0.5),
                                 [xmax]])
        rows.append(np.stack([xs, np.full(xs.size, y)], axis=-1))
    offs = np.cumsum([0] + [r.shape[0] for r in rows])
    verts = np.concatenate(rows, axis=0)
    tris = []
    for r in range(ny):
        lo, hi = rows[r], rows[r + 1]
        i = j = 0
        ilo, ihi = offs[r], offs[r + 1]
        # monotone strip triangulation: advance whichever side's next
        # vertex is nearer, keeping triangles CCW (lo is below hi in y)
        while i < lo.shape[0] - 1 or j < hi.shape[0] - 1:
            if j == hi.shape[0] - 1:
                take_lo = True
            elif i == lo.shape[0] - 1:
                take_lo = False
            else:
                d = lo[i + 1, 0] - hi[j + 1, 0]
                # on ties (the shared boundary columns) advance the side
                # whose CURRENT vertex trails — keeps every lattice
                # offset within one column at both straight edges
                take_lo = d < -1e-9 or (d < 1e-9 and lo[i, 0] < hi[j, 0])
            if take_lo:
                tris.append([ilo + i, ilo + i + 1, ihi + j])
                i += 1
            else:
                tris.append([ilo + i, ihi + j + 1, ihi + j])
                j += 1
    tris = np.asarray(tris, np.int32)
    # enforce CCW (positive signed area)
    d1 = verts[tris[:, 1]] - verts[tris[:, 0]]
    d2 = verts[tris[:, 2]] - verts[tris[:, 0]]
    cw = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0] < 0
    tris[cw] = tris[cw][:, [0, 2, 1]]
    return verts.astype(np.float64), tris


def border_refined_mesh(bbox, mesh_size, bd_width=None, interior_growth=3.0):
    """Tile mesh with fine border band + coarse interior, for stitching
    tiles where matches live near edges (behavioral counterpart of
    reference ``Mesh.from_boarder_bbox``, feabas/mesh.py:441).

    The border band is an equilateral lattice at ``mesh_size``; the interior
    at ``mesh_size * interior_growth``; boundary rectangle vertices are
    exact. Delaunay + centroid filtering assembles them.
    """
    xmin, ymin, xmax, ymax = bbox
    wd, ht = xmax - xmin, ymax - ymin
    if bd_width is None or not np.isfinite(bd_width):
        bd_width = max(wd, ht)  # fully fine
    bd_width = max(float(bd_width), 1.01 * mesh_size)
    ring = np.array([[xmin, ymin], [xmax, ymin], [xmax, ymax], [xmin, ymax]],
                    dtype=np.float64)
    b_pts = sp.resample_ring(ring, mesh_size)
    fine = sp.generate_equilat_grid_bbox(bbox, mesh_size)
    inb = ((fine[:, 0] > xmin) & (fine[:, 0] < xmax) &
           (fine[:, 1] > ymin) & (fine[:, 1] < ymax))
    fine = fine[inb]
    dist_edge = np.minimum.reduce([
        fine[:, 0] - xmin, xmax - fine[:, 0],
        fine[:, 1] - ymin, ymax - fine[:, 1]])
    band = fine[(dist_edge < bd_width) & (dist_edge > 0.4 * mesh_size)]
    pts = [b_pts, band]
    if bd_width < min(wd, ht) / 2:
        coarse_size = mesh_size * interior_growth
        coarse = sp.generate_equilat_grid_bbox(bbox, coarse_size)
        inc = ((coarse[:, 0] > xmin + bd_width) & (coarse[:, 0] < xmax - bd_width) &
               (coarse[:, 1] > ymin + bd_width) & (coarse[:, 1] < ymax - bd_width))
        pts.append(coarse[inc])
    pts = _dedupe(np.concatenate(pts, axis=0), 0.3 * mesh_size)
    tri = Delaunay(pts)
    T = tri.simplices.astype(np.int32)
    c = pts[T].mean(axis=1)
    keep = ((c[:, 0] > xmin) & (c[:, 0] < xmax) &
            (c[:, 1] > ymin) & (c[:, 1] < ymax))
    return compact_vertices(pts, T[keep])
