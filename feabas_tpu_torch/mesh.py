"""The FEM mesh: array-centric triangular mesh with multiple coordinate
"gears" (INITIAL / FIXED / MOVING / STAGING states held simultaneously).

Host-plane container (numpy) feeding device kernels: geometry queries run
vectorized on host or device; element arrays for the matrix-free solver are
exported by :meth:`Mesh.element_arrays`. Capability parity with reference
``feabas/mesh.py`` (a 3.4k-line class); H5 key names match the reference's
init-dict schema so mesh/tform files interchange.

The port's copy of ``feabas_tpu/mesh.py``, cut to what the port reaches.
"""


import numpy as np
import scipy.sparse as sparse
import scipy.sparse.csgraph as csgraph

from feabas_tpu_torch import constant as const
from feabas_tpu_torch import spatial as sp
from feabas_tpu_torch import trace
from feabas_tpu_torch import triangulation as tri_mod
from feabas_tpu_torch.material import MaterialTable
from feabas_tpu_torch.storage import H5File, join_paths
from feabas_tpu_torch.common import numpy_to_str_ascii, str_to_numpy_ascii
from feabas_tpu_torch.utils.spatial_index import GridIndex

_GEAR_NAMES = {
    const.MESH_GEAR_INITIAL: 'INITIAL',
    const.MESH_GEAR_FIXED: 'FIXED',
    const.MESH_GEAR_MOVING: 'MOVING',
    const.MESH_GEAR_STAGING: 'STAGING',
}


def gear_constant(gear):
    """Accept gear ints or names."""
    if isinstance(gear, str):
        return {v: k for k, v in _GEAR_NAMES.items()}[gear.upper()]
    return int(gear)


class Mesh:
    uid_counter = 0.0

    def __init__(self, vertices, triangles, **kwargs):
        vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 2)
        triangles = np.asarray(triangles, dtype=np.int32).reshape(-1, 3)
        G = const
        self._vertices = {G.MESH_GEAR_INITIAL: vertices}
        self._vertices[G.MESH_GEAR_FIXED] = kwargs.get('fixed_vertices', vertices)
        self._vertices[G.MESH_GEAR_MOVING] = kwargs.get('moving_vertices', None)
        self._vertices[G.MESH_GEAR_STAGING] = kwargs.get('staging_vertices', None)
        zero = np.zeros((1, 2), dtype=np.float64)
        self._offsets = {G.MESH_GEAR_INITIAL: np.asarray(
            kwargs.get('initial_offset', zero), np.float64).reshape(1, 2)}
        if ('fixed_vertices' not in kwargs) and ('fixed_offset' not in kwargs):
            self._offsets[G.MESH_GEAR_FIXED] = self._offsets[G.MESH_GEAR_INITIAL]
        else:
            self._offsets[G.MESH_GEAR_FIXED] = np.asarray(
                kwargs.get('fixed_offset', zero), np.float64).reshape(1, 2)
        self._offsets[G.MESH_GEAR_MOVING] = np.asarray(
            kwargs.get('moving_offset', zero), np.float64).reshape(1, 2)
        self._offsets[G.MESH_GEAR_STAGING] = np.asarray(
            kwargs.get('staging_offset', zero), np.float64).reshape(1, 2)

        mtb = kwargs.get('material_table', None)
        self.set_material_table(mtb)
        material_ids = kwargs.get('material_ids', None)
        if material_ids is None:
            material_ids = np.full(triangles.shape[0],
                                   self._material_table['default'].uid, np.int8)
        material_ids = np.asarray(material_ids).ravel().astype(np.int16)
        # triangles stored sorted by material so per-model element slices are
        # contiguous for the device kernels
        order = np.argsort(material_ids, kind='stable')
        self.triangles = triangles[order]
        self._material_ids = material_ids[order]
        self._stiffness_multiplier = kwargs.get('stiffness_multiplier', None)
        if isinstance(self._stiffness_multiplier, np.ndarray):
            self._stiffness_multiplier = self._stiffness_multiplier[order]

        from feabas_tpu_torch.config import data_resolution
        self._resolution = float(kwargs.get('resolution', data_resolution()))
        self._epsilon = float(kwargs.get('epsilon', const.EPSILON0))
        name = kwargs.get('name', '')
        self._name = numpy_to_str_ascii(name) if isinstance(name, (bytes, np.ndarray)) else str(name)
        self.locked = bool(kwargs.get('locked', False))
        self.soft_factor = float(kwargs.get('soft_factor', 1.0))
        self.is_outcast = False
        self.modified_in_current_session = bool(kwargs.get('modified', False))
        uid = kwargs.get('uid', None)
        if uid is None:
            self.uid = float(Mesh.uid_counter)
            Mesh.uid_counter += 1
        else:
            self.uid = float(uid)
            Mesh.uid_counter = float(max(Mesh.uid_counter, self.uid) + 1)
        self.token = kwargs.get('token', None)
        self._cache = {}

    # ------------------------- construction ------------------------- #

    @classmethod
    def from_bbox(cls, bbox, cartesian=True, **kwargs):
        mesh_size = kwargs.pop('mesh_size', 100.0)
        if cartesian:
            v, t = tri_mod.cartesian_mesh(
                bbox, mesh_size,
                max_aspect_ratio=kwargs.pop('max_aspect_ratio', 2.0),
                min_num_blocks=kwargs.pop('min_num_blocks', 1))
        else:
            # structured staggered lattice: same quality as the Delaunay
            # equilateral fill, but lattice-embeddable so window solves
            # over these sections run the gather-free stencil matvec
            # (fem.lattice_embedding / stack_solve grid_shape)
            v, t = tri_mod.equilateral_bbox_mesh(bbox, mesh_size)
        return cls(v, t, **kwargs)

    @classmethod
    def from_boarder_bbox(cls, bbox, bd_width=np.inf, **kwargs):
        mesh_size = kwargs.pop('mesh_size', 400.0)
        growth = kwargs.pop('mesh_growth', 3.0)
        v, t = tri_mod.border_refined_mesh(bbox, mesh_size, bd_width=bd_width,
                                           interior_growth=growth)
        return cls(v, t, **kwargs)

    @classmethod
    def from_polygon_equilateral(cls, mask_geom, **kwargs):
        """Equilateral mesh covering a Geometry's ROI."""
        mesh_size = kwargs.pop('mesh_size', 400.0)
        v, t, uids = tri_mod.triangulate_geometry(
            mask_geom, mesh_size,
            area_thresh=kwargs.pop('area_thresh', 0),
            simplify_tol=kwargs.pop('simplify_tol', 2.0),
            roi_tol=kwargs.pop('roi_tol', None),
            min_angle=kwargs.pop('min_mesh_angle', 0.0))
        kwargs.setdefault('material_table', mask_geom.material_table)
        return cls(v, t, material_ids=uids, **kwargs)

    from_geometry = from_polygon_equilateral

    def submesh(self, tri_mask, **kwargs):
        """New Mesh restricted to a triangle subset (all gears carried)."""
        tri_mask = np.asarray(tri_mask)
        if tri_mask.dtype == bool:
            tids = np.nonzero(tri_mask)[0]
        else:
            tids = tri_mask
        T = self.triangles[tids]
        used = np.unique(T)
        remap = np.full(self.num_vertices, -1, np.int64)
        remap[used] = np.arange(used.size)
        init_dict = {
            'material_ids': self._material_ids[tids],
            'material_table': self._material_table,
            'resolution': self._resolution,
            'locked': self.locked,
            'soft_factor': self.soft_factor,
            'name': self._name,
        }
        for gear in const.MESH_GEARS:
            v = self._vertices.get(gear)
            if v is not None:
                key = {const.MESH_GEAR_INITIAL: None,
                       const.MESH_GEAR_FIXED: 'fixed_vertices',
                       const.MESH_GEAR_MOVING: 'moving_vertices',
                       const.MESH_GEAR_STAGING: 'staging_vertices'}[gear]
                if key:
                    init_dict[key] = v[used]
                okey = {const.MESH_GEAR_INITIAL: 'initial_offset',
                        const.MESH_GEAR_FIXED: 'fixed_offset',
                        const.MESH_GEAR_MOVING: 'moving_offset',
                        const.MESH_GEAR_STAGING: 'staging_offset'}[gear]
                init_dict[okey] = self._offsets[gear]
        init_dict.update(kwargs)
        sub = Mesh(self._vertices[const.MESH_GEAR_INITIAL][used],
                   remap[T].astype(np.int32), **init_dict)
        # in-memory provenance so solvers can write component results back
        # into the parent (not serialized)
        sub._parent_mesh = self
        sub._parent_vertex_indices = used
        return sub

    def divide_disconnected_mesh(self, **kwargs):
        lbl_t = self.connected_triangles()
        if lbl_t.max() == 0:
            return [self]
        return [self.submesh(lbl_t == l, **kwargs) for l in range(lbl_t.max() + 1)]

    # ------------------------- H5 IO ------------------------- #

    def get_init_dict(self, save_material=True, **overrides):
        out = {
            'vertices': self._vertices[const.MESH_GEAR_INITIAL],
            'triangles': self.triangles,
            'material_ids': self._material_ids,
            'initial_offset': self._offsets[const.MESH_GEAR_INITIAL],
            'resolution': self._resolution,
            'name': self._name,
            'locked': self.locked,
            'soft_factor': self.soft_factor,
            'uid': self.uid,
        }
        if self._vertices[const.MESH_GEAR_FIXED] is not self._vertices[const.MESH_GEAR_INITIAL]:
            out['fixed_vertices'] = self._vertices[const.MESH_GEAR_FIXED]
            out['fixed_offset'] = self._offsets[const.MESH_GEAR_FIXED]
        for gear, key, okey in ((const.MESH_GEAR_MOVING, 'moving_vertices', 'moving_offset'),
                                (const.MESH_GEAR_STAGING, 'staging_vertices', 'staging_offset')):
            if self._vertices[gear] is not None:
                out[key] = self._vertices[gear]
                out[okey] = self._offsets[gear]
        if save_material:
            out['material_table'] = self._material_table.to_json()
        if isinstance(self._stiffness_multiplier, np.ndarray):
            out['stiffness_multiplier'] = self._stiffness_multiplier
        out.update(overrides)
        return out

    @trace.spanned('io.h5')
    def save_to_h5(self, fname, save_material=True, compression=True, prefix='',
                   **overrides):
        out = self.get_init_dict(save_material=save_material, **overrides)
        if prefix and not prefix.endswith('/'):
            prefix += '/'

        def _write(f):
            for key, val in out.items():
                if val is None:
                    continue
                if isinstance(val, str):
                    val = str_to_numpy_ascii(val)
                if np.isscalar(val) or not compression:
                    f.create_dataset(prefix + key, data=val)
                else:
                    f.create_dataset(prefix + key, data=val, compression='gzip')

        if hasattr(fname, 'create_dataset'):
            _write(fname)
        else:
            if '.h5' not in str(fname):
                fname = join_paths(fname, self._name + '.h5')
            with H5File(fname, 'w') as f:
                _write(f)

    @classmethod
    @trace.spanned('io.h5')
    def from_h5(cls, fname, prefix='', **kwargs):
        if prefix and not prefix.endswith('/'):
            prefix += '/'
        init = {}

        def _read(f):
            grp = f[prefix[:-1]] if prefix else f
            for key in grp.keys():
                init[key] = grp[key][()]

        if hasattr(fname, 'keys'):
            _read(fname)
        else:
            with H5File(str(fname), 'r') as f:
                _read(f)
        if 'material_table' in init:
            init['material_table'] = MaterialTable.from_pickleable(
                numpy_to_str_ascii(init['material_table']))
        if 'name' in init:
            init['name'] = numpy_to_str_ascii(init['name'])
        init.update(kwargs)
        return cls(**init)

    def copy(self, deep=True, **overrides):
        d = self.get_init_dict(**overrides)
        if deep:
            import copy as _copy
            d = _copy.deepcopy(d)
        if isinstance(d.get('material_table'), str):
            d['material_table'] = MaterialTable.from_pickleable(d['material_table'])
        return Mesh(**d)

    # ------------------------- materials ------------------------- #

    def set_material_table(self, mtb):
        if mtb is None:
            from feabas_tpu_torch.config import material_table
            try:
                mtb = material_table()
            except Exception:
                mtb = MaterialTable()
        elif isinstance(mtb, (str, bytes, np.ndarray, dict)):
            mtb = MaterialTable.from_pickleable(
                numpy_to_str_ascii(mtb) if isinstance(mtb, (bytes, np.ndarray)) else mtb)
        self._material_table = mtb

    @property
    def material_table(self):
        return self._material_table

    @property
    def material_ids(self):
        return self._material_ids

    # ------------------------- gear state ------------------------- #

    @property
    def num_vertices(self):
        return self._vertices[const.MESH_GEAR_INITIAL].shape[0]

    @property
    def num_triangles(self):
        return self.triangles.shape[0]

    @property
    def resolution(self):
        return self._resolution

    @property
    def name(self):
        return self._name

    def vertices_initialized(self, gear):
        return self._vertices.get(gear_constant(gear)) is not None

    def _resolve_gear(self, gear):
        """MOVING falls back to FIXED; STAGING falls back to MOVING."""
        gear = gear_constant(gear)
        if gear == const.MESH_GEAR_STAGING and self._vertices[gear] is None:
            gear = const.MESH_GEAR_MOVING
        if gear == const.MESH_GEAR_MOVING and self._vertices[gear] is None:
            gear = const.MESH_GEAR_FIXED
        return gear

    def vertices(self, gear=const.MESH_GEAR_MOVING):
        return np.asarray(self._vertices[self._resolve_gear(gear)])

    def offset(self, gear=const.MESH_GEAR_MOVING):
        return np.asarray(self._offsets[self._resolve_gear(gear)]).reshape(1, 2)

    def vertices_w_offset(self, gear=const.MESH_GEAR_MOVING):
        return self.vertices(gear) + self.offset(gear)

    def set_vertices(self, v, gear, offset=None):
        gear = gear_constant(gear)
        if gear == const.MESH_GEAR_INITIAL:
            raise ValueError('INITIAL gear is immutable')
        self._vertices[gear] = np.asarray(v, dtype=np.float64).reshape(-1, 2)
        if offset is not None:
            self._offsets[gear] = np.asarray(offset, np.float64).reshape(1, 2)
        self._cache.pop(gear, None)
        self.modified_in_current_session = True

    def set_offset(self, offset, gear):
        gear = gear_constant(gear)
        self._offsets[gear] = np.asarray(offset, np.float64).reshape(1, 2)
        self._cache.pop(gear, None)

    def change_resolution(self, new_resolution):
        scale = self._resolution / new_resolution
        if scale == 1.0:
            return self
        for gear in const.MESH_GEARS:
            if self._vertices[gear] is not None:
                self._vertices[gear] = self._vertices[gear] * scale
            self._offsets[gear] = self._offsets[gear] * scale
        self._resolution = float(new_resolution)
        self._cache.clear()
        return self

    # ------------------------- transforms ------------------------- #

    def set_translation(self, dxy, gear=(const.MESH_GEAR_FIXED, const.MESH_GEAR_MOVING)):
        src, dst = gear
        self.set_vertices(self.vertices(src), dst,
                          offset=self.offset(src) + np.asarray(dxy).reshape(1, 2))

    def apply_translation(self, dxy, gear):
        gear = gear_constant(gear)
        self.set_offset(self.offset(gear) + np.asarray(dxy).reshape(1, 2), gear)

    def apply_affine(self, T, gear=(const.MESH_GEAR_FIXED, const.MESH_GEAR_MOVING)):
        """Row-vector 3x3 affine applied to world coordinates of src gear,
        written into dst gear."""
        src, dst = gear
        vw = self.vertices_w_offset(src)
        out = sp.apply_affine(vw, T)
        center = out.mean(axis=0, keepdims=True)
        self.set_vertices(out - center, dst, offset=center)

    def anneal(self, gear=(const.MESH_GEAR_MOVING, const.MESH_GEAR_FIXED),
               mode=const.ANNEAL_COPY_EXACT):
        """Rebase the dst gear onto the src gear's configuration: COPY_EXACT
        copies it; GLOBAL_RIGID / GLOBAL_AFFINE fit one transform from dst
        to src and apply it to dst; CONNECTED_RIGID / CONNECTED_AFFINE fit
        one per connected component (components of fewer than 3 vertices
        stay)."""
        src, dst = gear
        if mode == const.ANNEAL_COPY_EXACT:
            self.set_vertices(self.vertices(src).copy(), dst,
                              offset=self.offset(src))
            return
        vw_src = self.vertices_w_offset(src)
        vw_dst = self.vertices_w_offset(dst)
        rigid = mode in (const.ANNEAL_GLOBAL_RIGID,
                         const.ANNEAL_CONNECTED_RIGID)
        if mode in (const.ANNEAL_CONNECTED_RIGID,
                    const.ANNEAL_CONNECTED_AFFINE):
            labels = self.connected_vertices()
            out = vw_dst.copy()
            for lbl in np.unique(labels):
                sel = labels == lbl
                if sel.sum() < 3:
                    continue
                T, T_rigid = sp.fit_affine(vw_src[sel], vw_dst[sel],
                                           return_rigid=True)
                out[sel] = sp.apply_affine(vw_dst[sel],
                                           T_rigid if rigid else T)
        else:
            T, T_rigid = sp.fit_affine(vw_src, vw_dst, return_rigid=True)
            out = sp.apply_affine(vw_dst, T_rigid if rigid else T)
        center = out.mean(axis=0, keepdims=True)
        self.set_vertices(out - center, dst, offset=center)

    # ------------------------- topology queries ------------------------- #

    def _memo(self, gear, key, fn):
        gear = self._resolve_gear(gear) if gear is not None else None
        d = self._cache.setdefault(gear, {})
        if key not in d:
            d[key] = fn()
        return d[key]

    def edges(self, directional=False):
        def _build():
            t = self.triangles
            e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]], axis=0)
            und = np.sort(e, axis=1)
            return np.unique(und, axis=0)
        und = self._memo(None, 'edges', _build)
        if directional:
            return np.concatenate([und, und[:, ::-1]], axis=0)
        return und

    def segments(self):
        """Boundary edges (those belonging to exactly one triangle)."""
        def _build():
            t = self.triangles
            e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]], axis=0)
            und = np.sort(e, axis=1)
            uniq, cnt = np.unique(und, axis=0, return_counts=True)
            return uniq[cnt == 1]
        return self._memo(None, 'segments', _build)

    def connected_vertices(self):
        def _build():
            e = self.edges()
            n = self.num_vertices
            g = sparse.coo_matrix((np.ones(e.shape[0]), (e[:, 0], e[:, 1])),
                                  shape=(n, n))
            ncomp, labels = csgraph.connected_components(g, directed=False)
            return labels
        return self._memo(None, 'conn_v', _build)

    def connected_triangles(self):
        return self.connected_vertices()[self.triangles[:, 0]]

    @property
    def num_connected(self):
        return int(self.connected_vertices().max()) + 1

    def bbox(self, gear=const.MESH_GEAR_MOVING, offsetting=True):
        v = self.vertices_w_offset(gear) if offsetting else self.vertices(gear)
        return np.concatenate([v.min(axis=0), v.max(axis=0)])

    def triangle_centers(self, gear=const.MESH_GEAR_MOVING):
        return self.vertices_w_offset(gear)[self.triangles].mean(axis=1)

    def triangle_bboxes(self, gear=const.MESH_GEAR_MOVING):
        p = self.vertices_w_offset(gear)[self.triangles]
        return np.concatenate([p.min(axis=1), p.max(axis=1)], axis=1)

    def triangle_areas(self, gear=const.MESH_GEAR_MOVING, signed=True):
        p = self.vertices(gear)[self.triangles]
        e0 = p[:, 1] - p[:, 0]
        e1 = p[:, 2] - p[:, 0]
        a = 0.5 * (e0[:, 0] * e1[:, 1] - e0[:, 1] * e1[:, 0])
        return a if signed else np.abs(a)

    def flipped_triangles(self, gear=const.MESH_GEAR_MOVING):
        a0 = self.triangle_areas(const.MESH_GEAR_INITIAL)
        a1 = self.triangle_areas(gear)
        return np.nonzero(np.sign(a0) * np.sign(a1) < 0)[0]

    # ------------------------- point location ------------------------- #

    def _tri_index(self, gear):
        def _build():
            return GridIndex(self.triangle_bboxes(gear))
        return self._memo(gear, 'tri_index', _build)

    def has_collisions(self, gear=const.MESH_GEAR_MOVING):
        """Whether any deformed triangles overlap in this gear (memoized;
        feeds collision-aware point location)."""
        return self._memo(
            gear, 'has_collisions',
            lambda: bool(self.overlapping_triangles(gear).shape[0] > 0))

    def likely_collisions(self, gear=const.MESH_GEAR_MOVING):
        """Cheap O(T) fold indicator: orientation-flipped triangles (a
        folded-over flap reverses its winding). Used where the exact
        overlap sweep (``has_collisions``) would cost seconds per section
        mesh; falls back to an exact memo if one was already computed."""
        g = self._resolve_gear(gear)
        exact = self._cache.get(g, {}).get('has_collisions', None)
        if exact is not None:
            return exact
        return self._memo(
            gear, 'likely_collisions',
            lambda: bool(self.flipped_triangles(gear).size > 0))

    def trifinder_weights(self, mode, gear=const.MESH_GEAR_MOVING):
        """Per-triangle arbitration weights for collision-aware point
        location (reference trifinder modes: feabas/mesh.py:2080-2190).

        LEAST_DEFORM favors the least-distorted sheet; INNERMOST the sheet
        whose triangles sit farthest from the mesh boundary (folds live at
        the boundary of the folded-over flap). Higher weight wins.
        """
        if isinstance(mode, str):
            mode = const.TRIFINDER_MODE_LIST.index(mode.upper())

        def _build():
            if mode == const.MESH_TRIFINDER_LEAST_DEFORM:
                deform = self.svds_to_deform(
                    gear0=const.MESH_GEAR_INITIAL, gear1=gear)
                return 1.0 / (1.0 + deform)
            if mode == const.MESH_TRIFINDER_INNERMOST:
                from scipy.spatial import cKDTree
                seg = self.segments()
                vinit = self.vertices_w_offset(const.MESH_GEAR_INITIAL)
                bd = vinit[np.unique(seg)] if seg.size else vinit[:1]
                cent = vinit[self.triangles].mean(axis=1)
                d, _ = cKDTree(bd).query(cent, k=1)
                return d
            return np.zeros(self.num_triangles)

        return self._memo(gear, f'trifinder_w{int(mode)}', _build)

    def tri_finder(self, pts, gear=const.MESH_GEAR_MOVING, extrapolate=False,
                   inside_tol=None, mode=None):
        """Containing triangle id per point (-1 outside). With
        ``extrapolate``, outside points snap to the nearest triangle center.
        When deformed triangles overlap (folds), ``mode``
        (LEAST_DEFORM | INNERMOST | WHATEVER) arbitrates which sheet a
        query point resolves to (reference: feabas/mesh.py:2080-2190);
        default keeps the first hit."""
        pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
        if inside_tol is None:
            inside_tol = -self._epsilon
        if isinstance(mode, str):
            mode = const.TRIFINDER_MODE_LIST.index(mode.upper())
        index = self._tri_index(gear)
        vw = self.vertices_w_offset(gear)
        T = self.triangles
        tid = np.full(pts.shape[0], -1, dtype=np.int64)
        pt_idx, cand = index.query_points_batch(pts)
        if pt_idx.size:
            bary = _barycentric_pointwise(pts[pt_idx], vw, T[cand])
            inside = (bary >= inside_tol).all(axis=-1)
            hits = np.nonzero(inside)[0]
            if mode in (const.MESH_TRIFINDER_LEAST_DEFORM,
                        const.MESH_TRIFINDER_INNERMOST) and hits.size:
                w = self.trifinder_weights(mode, gear=gear)
                # per point: keep the highest-weight containing triangle
                order = np.lexsort((-w[cand[hits]], pt_idx[hits]))
                hits = hits[order]
            # first hit per point (pairs are contiguous per point)
            u, first = np.unique(pt_idx[hits], return_index=True)
            tid[u] = cand[hits[first]]
        if extrapolate and (tid < 0).any():
            from scipy.spatial import cKDTree
            centers = self.triangle_centers(gear)
            tree = cKDTree(centers)
            missing = np.nonzero(tid < 0)[0]
            _, nn = tree.query(pts[missing], k=1)
            tid[missing] = nn
        return tid

    def cart2bary(self, pts, tid, gear=const.MESH_GEAR_MOVING):
        """Barycentric coordinates of world points w.r.t. triangles tid."""
        pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
        vw = self.vertices_w_offset(gear)
        return _barycentric_pointwise(pts, vw, self.triangles[tid])

    def bary2cart(self, tid, bary, gear=const.MESH_GEAR_MOVING):
        vw = self.vertices_w_offset(gear)
        tp = vw[self.triangles[np.asarray(tid)]]
        return np.einsum('nk,nkc->nc', np.asarray(bary, np.float64), tp)

    # ------------------------- deformation measures ------------------------- #

    def triangle_affine_tform(self, gear0=const.MESH_GEAR_INITIAL,
                              gear1=const.MESH_GEAR_MOVING):
        """Per-triangle 2x2 linear map + translation from gear0 to gear1."""
        p0 = self.vertices_w_offset(gear0)[self.triangles]
        p1 = self.vertices_w_offset(gear1)[self.triangles]
        e0 = np.stack([p0[:, 1] - p0[:, 0], p0[:, 2] - p0[:, 0]], axis=1)
        e1 = np.stack([p1[:, 1] - p1[:, 0], p1[:, 2] - p1[:, 0]], axis=1)
        A = np.linalg.solve(e0, e1)      # row-vector convention: e0 @ A = e1
        b = p1[:, 0] - p0[:, 0] @ A if False else p1[:, 0] - np.einsum('nc,ncd->nd', p0[:, 0], A)
        return A, b

    def tform_svd(self, gear0=const.MESH_GEAR_INITIAL, gear1=const.MESH_GEAR_MOVING):
        A, _ = self.triangle_affine_tform(gear0, gear1)
        return np.linalg.svd(A, compute_uv=False)

    def svds_to_deform(self, svds=None, **kwargs):
        """Scalar deformation per triangle: max |log singular value|."""
        if svds is None:
            svds = self.tform_svd(**kwargs)
        s = np.clip(np.abs(svds), 1e-12, None)
        return np.abs(np.log(s)).max(axis=-1)

    # ------------------------- FEM export ------------------------- #

    def element_arrays(self, gear=const.MESH_GEAR_INITIAL):
        """Per-model element slices for the device solver.

        Returns a list of dicts, one per constitutive model present:
        {model, slice(start, stop), tripts, multiplier, poisson, knots}.
        Multiplier folds material stiffness x per-triangle override x
        mesh soft_factor.
        """
        v = self.vertices(gear)
        uid2mat = self._material_table.uid_to_material()
        mult = np.empty(self.num_triangles, np.float32)
        poisson = np.empty(self.num_triangles, np.float32)
        model = np.empty(self.num_triangles, np.int8)
        knots = {}
        for uid in np.unique(self._material_ids):
            mat = uid2mat.get(int(uid))
            if mat is None:
                mat = self._material_table['default']
            sel = self._material_ids == uid
            mult[sel] = mat.stiffness_multiplier
            poisson[sel] = mat.poisson_ratio
            model[sel] = mat.type
            ck = mat.stiffness_curve_knots()
            if ck is not None:
                knots[int(uid)] = ck
        if isinstance(self._stiffness_multiplier, np.ndarray):
            mult = mult * self._stiffness_multiplier.astype(np.float32)
        elif self._stiffness_multiplier is not None:
            mult = mult * float(self._stiffness_multiplier)
        mult = mult * self.soft_factor
        groups = []
        # triangles are material-sorted; emit contiguous runs per model
        # type and stiffness curve. (The JAX package splits on the model
        # alone and gives a run the curve of its first triangle's material:
        # a mesh of the default material and the ENG 'wrinkle' solves with
        # no curve there.)
        curve = np.where(np.isin(self._material_ids, list(knots)),
                         self._material_ids, -2)
        boundaries = np.nonzero((np.diff(model) != 0)
                                | (np.diff(curve) != 0))[0] + 1
        starts = np.concatenate([[0], boundaries])
        stops = np.concatenate([boundaries, [self.num_triangles]])
        for s0, s1 in zip(starts, stops):
            uid_here = int(self._material_ids[s0])
            groups.append({
                'model': int(model[s0]),
                'start': int(s0), 'stop': int(s1),
                'tripts': v[self.triangles[s0:s1]],
                'multiplier': mult[s0:s1],
                'poisson': poisson[s0:s1],
                'knots': knots.get(uid_here),
            })
        return groups


# ------------------------- helpers ------------------------- #

def _barycentric_pointwise(pts, verts, tris):
    """pts (N,2) paired with tris (N,3) -> bary (N,3)."""
    tp = verts[tris]
    v0 = tp[:, 1] - tp[:, 0]
    v1 = tp[:, 2] - tp[:, 0]
    den = v0[:, 0] * v1[:, 1] - v0[:, 1] * v1[:, 0]
    den = np.where(np.abs(den) < 1e-12, 1e-12, den)
    d = pts - tp[:, 0]
    l1 = (d[:, 0] * v1[:, 1] - d[:, 1] * v1[:, 0]) / den
    l2 = (v0[:, 0] * d[:, 1] - v0[:, 1] * d[:, 0]) / den
    return np.stack([1.0 - l1 - l2, l1, l2], axis=-1)


def transform_mesh(mesh, carrier, gear=(const.MESH_GEAR_FIXED, const.MESH_GEAR_MOVING)):
    """Resample ``carrier``'s deformation at ``mesh``'s vertices: each vertex
    of ``mesh`` is located in carrier's src-gear mesh and mapped through its
    barycentric image in carrier's dst gear (reference: feabas/mesh.py:3367)."""
    src, dst = gear
    pts = mesh.vertices_w_offset(src)
    tid = carrier.tri_finder(pts, gear=src, extrapolate=True)
    bary = carrier.cart2bary(pts, tid, gear=src)
    out = carrier.bary2cart(tid, bary, gear=dst)
    new = mesh.copy()
    center = out.mean(axis=0, keepdims=True)
    new.set_vertices(out - center, dst, offset=center)
    return new


def _mesh_coarse(mesh, reduction_factor=0.25, gear=const.MESH_GEAR_INITIAL):
    """Coarse surrogate mesh covering the same region (reference
    _coarse_mesh_grids: feabas/mesh.py:871). reduction_factor scales the
    triangle count; 0 -> a single containing triangle (pure affine)."""
    bb = mesh.bbox(gear=gear)
    area = float(np.abs(mesh.triangle_areas(gear)).sum())
    ntri = max(int(mesh.num_triangles * reduction_factor), 0)
    if ntri < 4:
        # one big triangle containing the bbox: affine surrogate
        cx, cy = (bb[0] + bb[2]) / 2, (bb[1] + bb[3]) / 2
        r = 1.2 * np.hypot(bb[2] - bb[0], bb[3] - bb[1])
        theta = np.pi / 2 + np.arange(3) * 2 * np.pi / 3
        v = np.stack([cx + r * np.cos(theta), cy + r * np.sin(theta)], -1)
        t = np.array([[0, 1, 2]], np.int32)
        e01, e02 = v[1] - v[0], v[2] - v[0]
        soft = area / (0.5 * abs(e01[0] * e02[1] - e01[1] * e02[0]))
    else:
        side = np.sqrt(area / ntri * 4 / np.sqrt(3))
        pts = sp.generate_equilat_grid_bbox(bb, side)
        tid = mesh.tri_finder(pts, gear=gear)
        pts = pts[tid >= 0]
        if pts.shape[0] < 3:
            return _mesh_coarse(mesh, 0, gear)
        from scipy.spatial import Delaunay
        tri = Delaunay(pts)
        t = tri.simplices.astype(np.int32)
        cent = pts[t].mean(axis=1)
        keep = mesh.tri_finder(cent, gear=gear) >= 0
        if keep.sum() < 1:
            return _mesh_coarse(mesh, 0, gear)
        pts, t = tri_mod.compact_vertices(pts, t[keep])
        v = pts
        ca = np.abs(0.5 * ((v[t[:, 1]] - v[t[:, 0]])[:, 0]
                           * (v[t[:, 2]] - v[t[:, 0]])[:, 1]
                           - (v[t[:, 1]] - v[t[:, 0]])[:, 1]
                           * (v[t[:, 2]] - v[t[:, 0]])[:, 0])).sum()
        soft = area / max(ca, 1e-6)
    out = Mesh(v, t, resolution=mesh.resolution,
               material_table=mesh.material_table,
               soft_factor=mesh.soft_factor * float(np.clip(soft, 1e-3, 1.0)),
               uid=mesh.uid, name=mesh.name, locked=mesh.locked)
    return out


Mesh.coarse_mesh = _mesh_coarse


def _mesh_incise_region(mesh, material='split'):
    """Cut the mesh along a 'split' material band: interior split triangles
    (those not touching other materials) are removed, leaving a thin gap so
    the two sides deform independently (reference incise_region:
    feabas/mesh.py:955). Returns a new Mesh (or the original when the
    material is absent)."""
    try:
        uid = mesh.material_table[material].uid
    except KeyError:
        return mesh
    is_split = mesh.material_ids == uid
    if not is_split.any():
        return mesh
    # vertices touched by any non-split triangle
    nonsplit_verts = np.zeros(mesh.num_vertices, bool)
    nonsplit_verts[np.unique(mesh.triangles[~is_split])] = True
    touches_border = nonsplit_verts[mesh.triangles].any(axis=1)
    interior = is_split & ~touches_border
    if not interior.any():
        # band too thin to keep a soft border: remove the whole band
        interior = is_split
    return mesh.submesh(~interior)


Mesh.incise_region = _mesh_incise_region


def _orient(p, q, r):
    """Signed twice-area of (p, q, r); vectorized over leading dims."""
    return ((q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1])
            - (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0]))


def _tri_pairs_overlap(pa, pb):
    """Strict-interior overlap test for triangle pairs, fully vectorized.

    pa, pb: (P, 3, 2) triangle vertex coordinates. A pair overlaps when a
    vertex of one lies strictly inside the other, or any edge pair crosses
    properly. Boundary touching does not count (adjacent triangles are
    filtered out before this test anyway). Returns (P,) bool.
    """
    P = pa.shape[0]
    if P == 0:
        return np.zeros(0, bool)

    def any_vertex_inside(tri, pts):
        # pts (P,3,2) strictly inside tri (P,3,2): the three edge
        # orientations all share the triangle's winding sign
        a, b, c = tri[:, 0][:, None], tri[:, 1][:, None], tri[:, 2][:, None]
        s0 = _orient(a, b, pts)
        s1 = _orient(b, c, pts)
        s2 = _orient(c, a, pts)
        area = _orient(tri[:, 0], tri[:, 1], tri[:, 2])[:, None]
        tol = 1e-12 * np.abs(area) + 1e-30
        sgn = np.sign(area)
        inside = (s0 * sgn > tol) & (s1 * sgn > tol) & (s2 * sgn > tol)
        return inside.any(axis=1)

    # centroids catch exactly-coincident triangles (a reflection fold maps
    # vertices onto vertices, leaving every vertex on a boundary)
    ca = pa.mean(axis=1, keepdims=True)
    cb = pb.mean(axis=1, keepdims=True)
    hit = (any_vertex_inside(pa, pb) | any_vertex_inside(pb, pa)
           | any_vertex_inside(pa, cb) | any_vertex_inside(pb, ca))
    # proper edge-edge crossings: 3x3 segment combinations per pair
    # (catches thin slivers crossing without containing vertices — the
    # case the round-1 containment-only test missed)
    ea0 = pa                      # (P,3,2) segment starts
    ea1 = pa[:, [1, 2, 0]]        # segment ends
    eb0 = pb
    eb1 = pb[:, [1, 2, 0]]
    a0 = ea0[:, :, None]          # (P,3,1,2)
    a1 = ea1[:, :, None]
    b0 = eb0[:, None]             # (P,1,3,2)
    b1 = eb1[:, None]
    o1 = _orient(a0, a1, b0)
    o2 = _orient(a0, a1, b1)
    o3 = _orient(b0, b1, a0)
    o4 = _orient(b0, b1, a1)
    la = np.linalg.norm(ea1 - ea0, axis=-1)[:, :, None]
    lb = np.linalg.norm(eb1 - eb0, axis=-1)[:, None]
    tol = 1e-12 * (la * lb) ** 2 + 1e-30
    cross = (o1 * o2 < -tol) & (o3 * o4 < -tol)
    return hit | cross.any(axis=(1, 2))


def _mesh_overlapping_triangles(mesh, gear=const.MESH_GEAR_MOVING,
                                tri_mask=None):
    """Pairs of non-adjacent triangles that overlap after deformation
    (folds). Vectorized: bbox grid index -> candidate pairs -> strict
    vertex-containment + proper edge-crossing tests (reference collision
    machinery: feabas/mesh.py:2462-2893). Returns (K, 2) int64."""
    vw = mesh.vertices_w_offset(gear)
    T = mesh.triangles
    bb = mesh.triangle_bboxes(gear)
    if tri_mask is not None:
        sub = np.nonzero(np.asarray(tri_mask))[0] \
            if np.asarray(tri_mask).dtype == bool else np.asarray(tri_mask)
        gi = GridIndex(bb[sub])
        pairs = sub[gi.all_pairs()]
    else:
        gi = GridIndex(bb)
        pairs = gi.all_pairs()
    if pairs.shape[0] == 0:
        return np.empty((0, 2), np.int64)
    Ta = T[pairs[:, 0]]
    Tb = T[pairs[:, 1]]
    share = (Ta[:, :, None] == Tb[:, None, :]).any(axis=(1, 2))
    pairs = pairs[~share]
    if pairs.shape[0] == 0:
        return np.empty((0, 2), np.int64)
    pa = vw[T[pairs[:, 0]]]
    pb = vw[T[pairs[:, 1]]]
    return pairs[_tri_pairs_overlap(pa, pb)]


Mesh.overlapping_triangles = _mesh_overlapping_triangles
# reference naming (feabas/mesh.py:2462)
Mesh.triangle_collisions = _mesh_overlapping_triangles


def _mesh_nonoverlap_triangle_groups(mesh, gear=const.MESH_GEAR_MOVING,
                                     pairs=None):
    """Color triangles so no two overlapping triangles share a color
    (reference graph coloring + nonoverlap_triangle_groups:
    feabas/mesh.py:2774-2893). Returns (num_triangles,) int colors;
    non-colliding triangles get color 0, fold sheets get 1, 2, ...
    Greedy coloring on the conflict graph (small: only fold regions)."""
    if pairs is None:
        pairs = mesh.overlapping_triangles(gear=gear)
    colors = np.zeros(mesh.num_triangles, np.int64)
    if pairs.shape[0] == 0:
        return colors
    involved = np.unique(pairs)
    # grow conflict sets through triangle adjacency so each fold SHEET
    # (connected run of colliding triangles) keeps one color: conflict
    # graph edges = colliding pairs; same-sheet neighbors merge by union
    adj = {int(t): set() for t in involved}
    for a, b in pairs:
        adj[int(a)].add(int(b))
        adj[int(b)].add(int(a))
    # connected components over shared vertices among involved triangles —
    # but never merge two triangles that directly collide (fold-crease
    # neighbors must stay in different sheets)
    t2k = {int(t): k for k, t in enumerate(involved)}
    conflict_local = {(min(t2k[int(a)], t2k[int(b)]),
                       max(t2k[int(a)], t2k[int(b)])) for a, b in pairs}
    T = mesh.triangles[involved]
    v2t = {}
    for k, tvs in enumerate(T):
        for v in tvs:
            v2t.setdefault(int(v), []).append(k)
    comp = np.arange(involved.size)

    def find(x):
        while comp[x] != x:
            comp[x] = comp[comp[x]]
            x = comp[x]
        return x

    for members in v2t.values():
        for a in members:
            for b in members:
                if a >= b or (a, b) in conflict_local:
                    continue
                ra, rb = find(a), find(b)
                if ra != rb:
                    comp[rb] = ra
    sheet = np.asarray([find(k) for k in range(involved.size)])
    tri2sheet = {int(t): int(s) for t, s in zip(involved, sheet)}
    # sheet-level conflict graph
    sheets = np.unique(sheet)
    sconf = {int(s): set() for s in sheets}
    for a, b in pairs:
        sa, sb = tri2sheet[int(a)], tri2sheet[int(b)]
        if sa != sb:
            sconf[sa].add(sb)
            sconf[sb].add(sa)
    # greedy color sheets by degree (colors start at 1)
    order = sorted(sconf, key=lambda s: -len(sconf[s]))
    scolor = {}
    for s in order:
        used = {scolor[t] for t in sconf[s] if t in scolor}
        c = 1
        while c in used:
            c += 1
        scolor[s] = c
    for t in involved:
        colors[int(t)] = scolor[tri2sheet[int(t)]]
    # invariant repair: transitivity can still put a colliding pair in one
    # sheet; bump one side to a fresh color until no pair shares a color
    next_color = max(scolor.values(), default=0) + 1
    for _ in range(involved.size):
        bad = colors[pairs[:, 0]] == colors[pairs[:, 1]]
        if not bad.any():
            break
        for b in np.unique(pairs[bad][:, 1]):
            colors[int(b)] = next_color
            next_color += 1
    return colors


Mesh.nonoverlap_triangle_groups = _mesh_nonoverlap_triangle_groups


def _mesh_is_valid(mesh, gear=const.MESH_GEAR_MOVING):
    """No flipped triangles and no fold overlaps (reference: mesh.py:2462)."""
    if mesh.flipped_triangles(gear).size:
        return False
    return mesh.overlapping_triangles(gear).shape[0] == 0


Mesh.is_valid = _mesh_is_valid
