"""Uniform-grid spatial index over axis-aligned boxes.

Replaces rtree/STRtree for tile-overlap sweeps and triangle lookup
(reference uses: feabas/dal.py:932, feabas/mesh.py:2507). Fully
vectorized numpy; build O(N), all-pairs O(candidates) — sized so the
collision sweep over a 100k-triangle section stays well under a second.

The port's copy of ``feabas_tpu/utils/spatial_index.py``, cut to what the port reaches.
"""

import numpy as np


class GridIndex:
    def __init__(self, bboxes, cell_size=None):
        """bboxes: (N,4) [xmin,ymin,xmax,ymax]."""
        bboxes = np.asarray(bboxes, dtype=np.float64).reshape(-1, 4)
        self.bboxes = bboxes
        self._n = bboxes.shape[0]
        if self._n == 0:
            self._origin = np.zeros(2)
            self._cell = 1.0
            self._shape = (1, 1)
            self._keys = np.empty(0, np.int64)
            self._starts = np.zeros(1, np.int64)
            self._entries = np.empty(0, np.int64)
            return
        if cell_size is None:
            sizes = (bboxes[:, 2:] - bboxes[:, :2])
            cell_size = max(float(np.median(sizes)), 1e-6)
        self._cell = float(cell_size)
        self._origin = bboxes[:, :2].min(axis=0)
        extent = bboxes[:, 2:].max(axis=0) - self._origin
        nx = max(int(np.ceil(extent[0] / self._cell)), 1)
        ny = max(int(np.ceil(extent[1] / self._cell)), 1)
        self._shape = (nx, ny)
        i0 = np.floor((bboxes[:, 0] - self._origin[0]) / self._cell).astype(np.int64)
        i1 = np.floor((bboxes[:, 2] - self._origin[0]) / self._cell).astype(np.int64)
        j0 = np.floor((bboxes[:, 1] - self._origin[1]) / self._cell).astype(np.int64)
        j1 = np.floor((bboxes[:, 3] - self._origin[1]) / self._cell).astype(np.int64)
        i0, i1 = np.clip(i0, 0, nx - 1), np.clip(i1, 0, nx - 1)
        j0, j1 = np.clip(j0, 0, ny - 1), np.clip(j1, 0, ny - 1)
        # vectorized (cell, id) incidence expansion: each box occupies a
        # wx*wy rectangle of cells
        wx = i1 - i0 + 1
        wy = j1 - j0 + 1
        counts = wx * wy
        total = int(counts.sum())
        ids = np.repeat(np.arange(self._n, dtype=np.int64), counts)
        loc = np.arange(total, dtype=np.int64) \
            - np.repeat(np.cumsum(counts) - counts, counts)
        rwx = np.repeat(wx, counts)
        di = loc % rwx
        dj = loc // rwx
        cell = (np.repeat(i0, counts) + di) * ny + (np.repeat(j0, counts) + dj)
        order = np.argsort(cell, kind='stable')
        cell_sorted = cell[order]
        self._entries = ids[order]
        self._keys, run_starts = np.unique(cell_sorted, return_index=True)
        self._starts = np.concatenate([run_starts, [total]]).astype(np.int64)

    def _cell_entries(self, cell_id):
        k = np.searchsorted(self._keys, cell_id)
        if k >= self._keys.size or self._keys[k] != cell_id:
            return None
        return self._entries[self._starts[k]:self._starts[k + 1]]

    def query(self, bbox):
        """ids of boxes intersecting bbox (sorted, unique)."""
        if self._n == 0:
            return np.empty(0, dtype=np.int64)
        nx, ny = self._shape
        i0 = int(np.clip(np.floor((bbox[0] - self._origin[0]) / self._cell), 0, nx - 1))
        i1 = int(np.clip(np.floor((bbox[2] - self._origin[0]) / self._cell), 0, nx - 1))
        j0 = int(np.clip(np.floor((bbox[1] - self._origin[1]) / self._cell), 0, ny - 1))
        j1 = int(np.clip(np.floor((bbox[3] - self._origin[1]) / self._cell), 0, ny - 1))
        cand = []
        for ci in range(i0, i1 + 1):
            for cj in range(j0, j1 + 1):
                c = self._cell_entries(ci * ny + cj)
                if c is not None:
                    cand.append(c)
        if not cand:
            return np.empty(0, dtype=np.int64)
        cand = np.unique(np.concatenate(cand))
        b = self.bboxes[cand]
        hit = ((b[:, 0] < bbox[2]) & (b[:, 2] > bbox[0]) &
               (b[:, 1] < bbox[3]) & (b[:, 3] > bbox[1]))
        return cand[hit]

    def query_point(self, xy):
        return self.query((xy[0], xy[1], xy[0], xy[1]))

    def query_points_batch(self, pts):
        """Candidate pairs for many points at once.

        Returns (pt_idx, box_idx) int arrays: for each point, the boxes of
        its grid cell whose extent contains the point. Grouped by cell so
        cost scales with unique cells, not points."""
        pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
        if self._n == 0 or pts.shape[0] == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        nx, ny = self._shape
        ci = np.clip(np.floor((pts[:, 0] - self._origin[0]) / self._cell),
                     0, nx - 1).astype(np.int64)
        cj = np.clip(np.floor((pts[:, 1] - self._origin[1]) / self._cell),
                     0, ny - 1).astype(np.int64)
        cell_ids = ci * ny + cj
        # map each point's cell to its run in the sorted (cell -> entries)
        # layout; vectorized expansion of candidates per point
        k = np.searchsorted(self._keys, cell_ids)
        k_ok = (k < self._keys.size)
        k_safe = np.where(k_ok, k, 0)
        hit_cell = k_ok & (self._keys[k_safe] == cell_ids)
        pt_ids = np.nonzero(hit_cell)[0]
        if pt_ids.size == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        kk = k_safe[pt_ids]
        c0 = self._starts[kk]
        c1 = self._starts[kk + 1]
        counts = c1 - c0
        pt_idx = np.repeat(pt_ids, counts)
        loc = np.arange(int(counts.sum()), dtype=np.int64) \
            - np.repeat(np.cumsum(counts) - counts, counts)
        box_idx = self._entries[np.repeat(c0, counts) + loc]
        b = self.bboxes[box_idx]
        p = pts[pt_idx]
        hit = ((b[:, 0] <= p[:, 0]) & (b[:, 2] >= p[:, 0]) &
               (b[:, 1] <= p[:, 1]) & (b[:, 3] >= p[:, 1]))
        return pt_idx[hit], box_idx[hit]

    def all_pairs(self):
        """All bbox-intersecting (i, j) pairs with i < j, vectorized.

        Cells are grouped by occupancy count so pair generation is one
        ``triu_indices`` broadcast per distinct count, not a Python loop
        over cells."""
        if self._n == 0 or self._entries.size == 0:
            return np.empty((0, 2), dtype=np.int64)
        counts = np.diff(self._starts)
        out_i, out_j = [], []
        for k in np.unique(counts):
            if k < 2:
                continue
            sel = np.nonzero(counts == k)[0]
            # (n_cells_k, k) matrix of entry ids
            rows = self._starts[sel][:, None] + np.arange(k)[None, :]
            mat = self._entries[rows]
            iu, ju = np.triu_indices(int(k), 1)
            out_i.append(mat[:, iu].ravel())
            out_j.append(mat[:, ju].ravel())
        if not out_i:
            return np.empty((0, 2), dtype=np.int64)
        pi = np.concatenate(out_i)
        pj = np.concatenate(out_j)
        lo = np.minimum(pi, pj)
        hi = np.maximum(pi, pj)
        # scalar keys dedupe ~20x faster than unique(axis=0)'s void sort
        keys = np.unique(lo * np.int64(self._n) + hi)
        pairs = np.stack([keys // self._n, keys % self._n], axis=-1)
        b0 = self.bboxes[pairs[:, 0]]
        b1 = self.bboxes[pairs[:, 1]]
        hit = ((b0[:, 0] < b1[:, 2]) & (b0[:, 2] > b1[:, 0]) &
               (b0[:, 1] < b1[:, 3]) & (b0[:, 3] > b1[:, 1]))
        return pairs[hit]
