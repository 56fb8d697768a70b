"""Per-section 2D stitching (counterpart of ``feabas_tpu/stitcher.py``).

`Stitcher` carries one section's tiles through overlap detection, pair
matching, mesh initialization and the solver cascade; `MontageRenderer`
composes the solved tiles into output tiles. Both compute on one torch
device (``device.get_device``). On a CUDA device every stage runs in this
process: one CUDA context per spawned worker would fight over the card.
On the CPU the configured worker fan-out stays.
"""

import numpy as np
import scipy.sparse as sparse
import torch

from feabas_tpu_torch import common, config, storage, trace
from feabas_tpu_torch import constant as const
from feabas_tpu_torch import spatial as sp
from feabas_tpu_torch.common import (Match, bbox_centers, intersect_bbox,
                                     numpy_to_str_ascii, str_to_numpy_ascii,
                                     z_order)
from feabas_tpu_torch.concurrent import submit_to_workers
from feabas_tpu_torch.dal import StaticImageLoader, get_loader_from_json
from feabas_tpu_torch.mesh import Mesh
from feabas_tpu_torch.renderer import MeshRenderer
from feabas_tpu_torch.storage import H5File, join_paths
from feabas_tpu_torch.utils.spatial_index import GridIndex
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch.optimizer import SLM, _sparse_spd_solve, relax_mesh
from feabas_tpu_torch.renderer import resolve_device_render


# the section solves run in f32 on the device, as the JAX package does
# in production
SOLVER_DTYPE = torch.float32


def _run_jobs(func, args, num_workers, dev):
    """Results of ``func(*a)`` for each job: in this process on a CUDA
    device, through the configured worker pool otherwise."""
    if dev.type == 'cuda':
        return (func(*a) for a in args)
    return submit_to_workers(func, args, num_workers=num_workers)


class Stitcher:
    """One section: tiles + matches + meshes."""

    def __init__(self, imgpaths, bboxes, root_dir=None, **kwargs):
        self.imgpaths = list(imgpaths)
        self.init_bboxes = np.asarray(bboxes, np.float64).reshape(-1, 4)
        self.root_dir = root_dir
        self.resolution = kwargs.get('resolution', None) or config.data_resolution()
        self.name = kwargs.get('name', '')
        self.matches = {}      # (i, j) -> Match in tile-local coords
        self.meshes = None     # list[Mesh] after initialize_meshes
        self.groupings = kwargs.get('groupings', None)
        self.photometrics = {}
        self.tile_transfers = None
        self.device = device_mod.get_device(kwargs.get('device', None))

    @classmethod
    def from_coordinate_file(cls, filename, **kwargs):
        imgpaths, bboxes, root_dir, resolution = common.parse_coordinate_files(filename)
        name = kwargs.pop('name', None)
        if name is None:
            name = join_paths(filename).split('/')[-1].rsplit('.', 1)[0] \
                if '/' in str(filename) else str(filename).rsplit('.', 1)[0]
        return cls(imgpaths, bboxes, root_dir=root_dir, resolution=resolution,
                   name=name, **kwargs)

    @property
    def num_tiles(self):
        return len(self.imgpaths)

    def loader(self, **kwargs):
        return StaticImageLoader(self.imgpaths, self.init_bboxes,
                                 root_dir=self.root_dir,
                                 resolution=self.resolution, **kwargs)

    # ------------------------- matching ------------------------- #

    def find_overlaps(self, min_overlap_width=0):
        """Tile pairs whose stage bboxes overlap, z-ordered."""
        gi = GridIndex(self.init_bboxes)
        keep = []
        for i, j in gi.all_pairs():
            ovl, valid = intersect_bbox(self.init_bboxes[i], self.init_bboxes[j])
            if not valid:
                continue
            if min(ovl[2] - ovl[0], ovl[3] - ovl[1]) < min_overlap_width:
                continue
            keep.append((i, j))
        if not keep:
            return np.zeros((0, 2), dtype=np.int64)
        keep = np.asarray(keep, dtype=np.int64)
        centers = (bbox_centers(self.init_bboxes[keep[:, 0]])
                   + bbox_centers(self.init_bboxes[keep[:, 1]])) / 2
        order = z_order(np.round(centers / max(np.ptp(centers, 0).max() / 64, 1)).astype(int))
        return keep[order]

    def dispatch_matchers(self, **settings):
        """Match all overlapping pairs into ``self.matches``. After the
        first pass, stage positions are refined from the matches and
        failed overlaps get a second chance with a doubled margin.
        Returns the matched count."""
        num_workers = settings.pop('num_workers', 1)
        min_overlap_width = settings.pop('min_overlap_width', 25)
        margin = settings.pop('margin', 100)
        num_overlaps_per_job = settings.pop('num_overlaps_per_job', 180)
        loader_config = settings.pop('loader_config', {})
        matcher_config = settings.pop('matcher_config', {})
        second_chance = settings.pop('second_chance', True)
        overlaps = self.find_overlaps(min_overlap_width=min_overlap_width)
        overlaps = [tuple(p) for p in overlaps if tuple(p) not in self.matches]
        if not overlaps:
            return 0
        n = self._dispatch_batch(overlaps, self.init_bboxes, margin,
                                 loader_config, matcher_config, num_workers,
                                 num_overlaps_per_job)
        missing = [p for p in overlaps if p not in self.matches]
        if second_chance and missing and self.matches:
            refined = self.refine_stage_positions()
            n += self._dispatch_batch(missing, refined, margin * 2,
                                      loader_config, matcher_config,
                                      num_workers, num_overlaps_per_job)
        return n

    def _dispatch_batch(self, overlaps, bboxes, margin, loader_config,
                        matcher_config, num_workers, num_overlaps_per_job):
        loader_config = dict(loader_config or {})
        if 'cache_border_margin' not in loader_config and overlaps:
            widths = []
            for i, j in overlaps:
                ovl, valid = intersect_bbox(bboxes[i], bboxes[j])
                if valid:
                    widths.append(min(ovl[2] - ovl[0], ovl[3] - ovl[1]))
            if widths:
                loader_config['cache_border_margin'] = int(
                    np.median(widths) + 2 * margin)
        loader = StaticImageLoader(self.imgpaths, bboxes,
                                   root_dir=self.root_dir,
                                   resolution=self.resolution, **loader_config)
        loader_spec = loader.to_dict()
        jobs = [overlaps[i:i + num_overlaps_per_job]
                for i in range(0, len(overlaps), num_overlaps_per_job)]
        args = [(loader_spec, list(job), margin, matcher_config,
                 str(self.device)) for job in jobs]
        n = 0
        for result in _run_jobs(subprocess_match_list_of_overlaps, args,
                                num_workers, self.device):
            for key, match, photometric, err in result:
                if err is not None:
                    continue
                if photometric is not None:
                    self.photometrics[tuple(key)] = photometric
                if match is not None:
                    self.matches[tuple(key)] = match
                    n += 1
        return n

    def refine_stage_positions(self):
        """Least-squares per-tile translations from the matches so far.
        Returns refined bboxes (stage coordinates stay unmodified)."""
        n = self.num_tiles
        stage_o = self.init_bboxes[:, :2]
        ii, jj, vv = [], [], []
        Atb = np.zeros((n, 2))
        for (i, j), m in self.matches.items():
            w2 = np.asarray(m.weight) ** 2
            sw = w2.sum()
            if sw <= 0:
                continue
            t = (((m.xy0 - m.xy1) * w2[:, None]).sum(axis=0) / sw
                 - (stage_o[j] - stage_o[i]))
            ii.extend((i, j, i, j))
            jj.extend((i, j, j, i))
            vv.extend((sw, sw, -sw, -sw))
            Atb[i] -= sw * t
            Atb[j] += sw * t
        AtA = sparse.coo_matrix(
            (np.asarray(vv, np.float64), (ii, jj)), shape=(n, n)).tocsr()
        diag = AtA.diagonal()
        ridge = max(diag.max(initial=0.0), 1.0) * 1e-6
        AtA = AtA + sparse.identity(n, format='csr') * ridge
        c = _sparse_spd_solve(AtA, Atb, diag + ridge)
        if c is None:
            return self.init_bboxes
        c -= c.mean(axis=0, keepdims=True)
        refined = self.init_bboxes.copy()
        refined[:, 0::2] += c[:, :1]
        refined[:, 1::2] += c[:, 1:]
        return refined

    # ------------------------- H5 IO ------------------------- #

    @trace.spanned('io.h5')
    def save_to_h5(self, fname, save_matches=True, save_meshes=True):
        with H5File(fname, 'w') as f:
            f.create_dataset('imgpaths', data=str_to_numpy_ascii('\n'.join(self.imgpaths)))
            f.create_dataset('bboxes', data=self.init_bboxes)
            if self.root_dir:
                f.create_dataset('root_dir', data=str_to_numpy_ascii(self.root_dir))
            f.create_dataset('resolution', data=float(self.resolution))
            f.create_dataset('name', data=str_to_numpy_ascii(self.name or ''))
            if save_matches:
                for (i, j), m in self.matches.items():
                    g = f'matches/{i}_{j}/'
                    f.create_dataset(g + 'xy0', data=m.xy0)
                    f.create_dataset(g + 'xy1', data=m.xy1)
                    f.create_dataset(g + 'weight', data=m.weight)
                    f.create_dataset(g + 'strain', data=float(m.strain))
            if save_matches and self.photometrics:
                keys = sorted(self.photometrics.keys())
                f.create_dataset('photometrics/pairs',
                                 data=np.asarray(keys, np.int64))
                f.create_dataset('photometrics/stats', data=np.asarray(
                    [self.photometrics[k] for k in keys], np.float64))
            if self.tile_transfers is not None:
                f.create_dataset('tile_transfers', data=self.tile_transfers)
            if self.groupings is not None:
                f.create_dataset('groupings', data=np.asarray(self.groupings))
            if save_meshes and self.meshes is not None:
                for i, mesh in enumerate(self.meshes):
                    mesh.save_to_h5(f, prefix=f'meshes/{i}', save_material=(i == 0))

    @classmethod
    @trace.spanned('io.h5')
    def from_h5(cls, fname, load_matches=True, load_meshes=True, **kwargs):
        with H5File(fname, 'r') as f:
            imgpaths = numpy_to_str_ascii(f['imgpaths'][()]).split('\n')
            bboxes = f['bboxes'][()]
            root_dir = numpy_to_str_ascii(f['root_dir'][()]) if 'root_dir' in f else None
            resolution = float(f['resolution'][()])
            name = numpy_to_str_ascii(f['name'][()])
            obj = cls(imgpaths, bboxes, root_dir=root_dir, resolution=resolution,
                      name=name, **kwargs)
            if load_matches and 'matches' in f:
                for key in f['matches'].keys():
                    i, j = (int(s) for s in key.split('_'))
                    g = f[f'matches/{key}']
                    obj.matches[(i, j)] = Match(
                        g['xy0'][()], g['xy1'][()], g['weight'][()],
                        float(g['strain'][()]))
            if load_matches and 'photometrics' in f:
                pairs = f['photometrics/pairs'][()]
                stats = f['photometrics/stats'][()]
                obj.photometrics = {tuple(int(v) for v in p): tuple(s)
                                    for p, s in zip(pairs, stats)}
            if 'tile_transfers' in f:
                obj.tile_transfers = f['tile_transfers'][()]
            if 'groupings' in f:
                obj.groupings = f['groupings'][()]
            if load_meshes and 'meshes' in f:
                keys = sorted(f['meshes'].keys(), key=int)
                obj.meshes = [Mesh.from_h5(f, prefix=f'meshes/{k}') for k in keys]
        return obj

    # ------------------------- optimization ------------------------- #

    def initialize_meshes(self, mesh_sizes=(100, 300), border_width=None,
                          soft_top=0.2, soft_top_width=0.0, **kwargs):
        """Per-tile border-refined meshes; mesh size picked from the
        observed match strain, per-tile soft factors from per-tile
        strain."""
        strains = [m.strain for m in self.matches.values()] or [config.DEFAULT_AVG_DEFORM]
        strain = float(np.median(strains))
        mesh_sizes = sorted(np.atleast_1d(mesh_sizes))
        idx = 0 if strain > 2 * config.DEFAULT_AVG_DEFORM else len(mesh_sizes) - 1
        mesh_size = float(mesh_sizes[idx])
        if border_width is None:
            ovw = []
            for i, j in self.matches.keys():
                ovl, valid = intersect_bbox(self.init_bboxes[i], self.init_bboxes[j])
                if valid:
                    ovw.append(min(ovl[2] - ovl[0], ovl[3] - ovl[1]))
            border_width = float(np.median(ovw)) if ovw else np.inf
        n_tiles = len(self.init_bboxes)
        tile_soft = np.ones(n_tiles, np.float64)
        per_tile = [[] for _ in range(n_tiles)]
        iface = {}
        groupings = self.groupings
        for (i, j), m in self.matches.items():
            s = float(m.strain)
            if not np.isfinite(s):
                continue
            per_tile[i].append(s)
            per_tile[j].append(s)
            if groupings is not None and groupings[i] != groupings[j]:
                iface.setdefault(groupings[i], []).append(s)
                iface.setdefault(groupings[j], []).append(s)
        if any(per_tile) and kwargs.get('strain_soft_factors', True):
            solo = np.zeros(n_tiles)
            for k, vals in enumerate(per_tile):
                if vals:
                    solo[k] = np.median(vals)
            group = np.zeros(n_tiles)
            if groupings is not None:
                for g, vals in iface.items():
                    group[np.asarray(groupings) == g] = np.median(vals)
            avg_strain = np.maximum(solo, group)
            tile_px = max(float(np.median(
                [max(b[2] - b[0], b[3] - b[1]) for b in self.init_bboxes])), 1.0)
            tile_soft = 1.0 / (avg_strain + 1.0 / tile_px)
            tile_soft = tile_soft / tile_soft.mean()
            tile_soft = np.clip(tile_soft, None, 2.5)
        self.meshes = []
        templates = {}
        for i, bbox in enumerate(self.init_bboxes):
            wd = round(float(bbox[2] - bbox[0]), 3)
            ht = round(float(bbox[3] - bbox[1]), 3)
            key = (wd, ht)
            if key not in templates:
                templates[key] = Mesh.from_boarder_bbox(
                    (0, 0, wd, ht), bd_width=border_width,
                    mesh_size=mesh_size, resolution=self.resolution,
                    uid=-1, name='template')
            m = templates[key].copy(deep=True, uid=i, name=f'tile{i}')
            m.soft_factor = float(tile_soft[i])
            if soft_top < 1.0 and soft_top_width > 0:
                cy = m.vertices(const.MESH_GEAR_INITIAL)[m.triangles].mean(1)[:, 1]
                t = np.clip(cy / max(ht * soft_top_width, 1e-6), 0, 1)
                m._stiffness_multiplier = soft_top + (1 - soft_top) * t
            m.set_translation((bbox[0], bbox[1]),
                              gear=(const.MESH_GEAR_INITIAL, const.MESH_GEAR_FIXED))
            self.meshes.append(m)
        return mesh_size

    def initialize_optimizer(self, minweight=0.1, **kwargs):
        if self.meshes is None:
            self.initialize_meshes(**kwargs.pop('mesh_settings', {}))
        slm = SLM(self.meshes, dtype=SOLVER_DTYPE, device=self.device)
        for (i, j), m in self.matches.items():
            w = np.asarray(m.weight)
            keep = w >= minweight
            if not keep.any():
                continue
            slm.add_link_from_coordinates(
                i, j, m.xy0[keep], m.xy1[keep], weight=w[keep],
                gear=(const.MESH_GEAR_INITIAL, const.MESH_GEAR_INITIAL))
        self._slm = slm
        return slm

    def optimize_translation(self, **kwargs):
        """Tile translations from the stage coords (FIXED as start)."""
        slm = getattr(self, '_slm', None) or self.initialize_optimizer(**kwargs)
        slm.optimize_translation_w_filtering(
            start_gear=const.MESH_GEAR_FIXED,
            target_gear=const.MESH_GEAR_MOVING,
            residue_threshold=kwargs.get('residue_threshold', None))
        return slm

    def optimize_elastic(self, **kwargs):
        """Final elastic relaxation. With ``use_groupings``, tiles of one
        group share one deformation (the grouped solve of
        ``SLM.optimize_linear``)."""
        slm = getattr(self, '_slm', None) or self.initialize_optimizer()
        kwargs.setdefault('stiffness_lambda', -1.0)
        kwargs.setdefault('crosslink_lambda', -1.0)
        kwargs.setdefault('residue_mode', 'huber')
        kwargs.setdefault('residue_len', 3)
        if kwargs.pop('use_groupings', False) and self.groupings is not None:
            uid2idx = {id(m): i for i, m in enumerate(self.meshes)}
            kwargs['groupings'] = np.asarray(
                [self.groupings[uid2idx[id(m)]] for m in slm.meshes])
        cost = slm.optimize_elastic(
            **{k: v for k, v in kwargs.items()
               if k in ('stiffness_lambda', 'crosslink_lambda', 'residue_mode',
                        'residue_len', 'tol', 'atol', 'maxiter',
                        'max_residue_passes', 'groupings', 'chances')})
        self.last_solve_converged = getattr(slm, 'last_solve_converged', True)
        return cost

    def set_groupings(self, groupings=None, msem=False):
        """Per-tile group ids (e.g. mFoV for MultiSEM data)."""
        if groupings is not None:
            self.groupings = np.asarray(groupings)
        elif msem:
            from feabas_tpu_torch.multisem import mfovids_beamids_from_filenames
            mfovs, _ = mfovids_beamids_from_filenames(self.imgpaths)
            self.groupings = mfovs
        return self.groupings

    def optimize_affine(self, **kwargs):
        """One affine per tile group (or per tile), starting from the
        translation stage's placement."""
        slm = getattr(self, '_slm', None) or self.initialize_optimizer()
        use_group = kwargs.get('use_group', True) and self.groupings is not None
        return slm.optimize_affine_cascade(
            start_gear=const.MESH_GEAR_MOVING,
            target_gear=const.MESH_GEAR_MOVING,
            groupings=self.groupings if use_group else None)

    def optimize_group_intersection(self, **kwargs):
        """Relax only inter-group interfaces: tiles with no links to other
        groups stay locked."""
        if self.groupings is None:
            return None
        slm = getattr(self, '_slm', None) or self.initialize_optimizer()
        uid2idx = {m.uid: i for i, m in enumerate(slm.meshes)}
        interface = np.zeros(slm.num_meshes, bool)
        for l in slm.active_links():
            i0, i1 = uid2idx[l.uids[0]], uid2idx[l.uids[1]]
            if self.groupings[i0] != self.groupings[i1]:
                interface[i0] = interface[i1] = True
        was_locked = [m.locked for m in slm.meshes]
        for m, iface in zip(slm.meshes, interface):
            m.locked = m.locked or (not iface)
        try:
            out = slm.optimize_elastic(
                stiffness_lambda=kwargs.get('stiffness_lambda', -1.0),
                crosslink_lambda=-1.0,
                residue_mode=kwargs.get('residue_mode', 'threshold'),
                residue_len=kwargs.get('residue_len', 3),
                tol=kwargs.get('tol', 1e-6))
        finally:
            for m, lk in zip(slm.meshes, was_locked):
                m.locked = lk
        return out

    def correct_invalid_meshes(self, **kwargs):
        """Locally relax meshes with flipped or fold-overlapping triangles
        after the global solve. Returns the number repaired."""
        if self.meshes is None:
            return 0
        n = 0
        for m in self.meshes:
            flipped = m.flipped_triangles(const.MESH_GEAR_MOVING)
            bad = np.unique(np.concatenate([
                flipped,
                m.overlapping_triangles(const.MESH_GEAR_MOVING).ravel()]))
            if bad.size == 0:
                continue
            free = np.zeros(m.num_vertices, bool)
            free[np.unique(m.triangles[bad])] = True
            e = m.edges()
            sel = free[e[:, 0]] | free[e[:, 1]]
            free[np.unique(e[sel])] = True
            relax_mesh(m, free_vertices=free, dtype=SOLVER_DTYPE,
                       device=self.device)
            n += 1
        return n

    def equalize_brightness_contrast(self, anchor_gain=1.0, regularize=0.1,
                                     **kwargs):
        """Per-tile linear intensity transfer (gain, offset) from overlap
        photometrics; stores ``self.tile_transfers``."""
        if not self.photometrics:
            return None
        n = self.num_tiles
        A = np.eye(n) * regularize
        bg = np.zeros(n)
        bo_A = np.eye(n) * regularize
        bo = np.zeros(n)
        stats = {}
        for (i, j), (mi, si, mj, sj) in self.photometrics.items():
            if si <= 0 or sj <= 0:
                continue
            t = np.log(sj / si)
            A[i, i] += 1
            A[j, j] += 1
            A[i, j] -= 1
            A[j, i] -= 1
            bg[i] += t
            bg[j] -= t
            stats[(i, j)] = (mi, mj)
        logg = np.linalg.lstsq(A, bg, rcond=None)[0]
        logg -= logg.mean()
        gains = np.exp(logg) * anchor_gain
        for (i, j), (mi, mj) in stats.items():
            t = gains[j] * mj - gains[i] * mi
            bo_A[i, i] += 1
            bo_A[j, j] += 1
            bo_A[i, j] -= 1
            bo_A[j, i] -= 1
            bo[i] += t
            bo[j] -= t
        offsets = np.linalg.lstsq(bo_A, bo, rcond=None)[0]
        offsets -= offsets.mean()
        self.tile_transfers = np.stack([gains, offsets], axis=-1)
        return self.tile_transfers

    def connect_isolated_subsystem(self, explode_factor=1.0, **kwargs):
        """Re-place link-disconnected components by their stage coords."""
        slm = self._slm
        labels = slm.mesh_connectivity()
        if labels.max() == 0:
            return 0
        anchor = np.argmax(np.bincount(labels))
        for lbl in np.unique(labels):
            if lbl == anchor:
                continue
            sel = labels == lbl
            dxy = [slm.meshes[i].offset(const.MESH_GEAR_MOVING)
                   - slm.meshes[i].offset(const.MESH_GEAR_FIXED)
                   for i in np.nonzero(sel)[0]]
            mean_d = np.mean(dxy, axis=0)
            for i in np.nonzero(sel)[0]:
                m = slm.meshes[i]
                want = m.offset(const.MESH_GEAR_FIXED) * explode_factor + mean_d
                m.set_offset(want, const.MESH_GEAR_MOVING)
        return int(labels.max())

    def normalize_coordinates(self, rotation_threshold=None, offset=(1, 1), **kwargs):
        """Rigidly normalize the solved section: undo a connected
        subsystem's median rotation beyond ``rotation_threshold`` degrees,
        then shift the section bbox corner to ``offset``."""
        if self.meshes is None:
            return
        if rotation_threshold is not None:
            slm = getattr(self, '_slm', None)
            if (slm is not None and len(slm.meshes) == len(self.meshes)
                    and all(a is b for a, b in zip(slm.meshes, self.meshes))):
                labels = slm.mesh_connectivity()
            else:
                labels = np.zeros(len(self.meshes), dtype=np.int64)
            gear = (const.MESH_GEAR_INITIAL, const.MESH_GEAR_MOVING)
            rotations = []
            for m in self.meshes:
                _, R = sp.fit_affine(m.vertices_w_offset(gear[1]),
                                     m.vertices_w_offset(gear[0]),
                                     return_rigid=True)
                rotations.append(np.arctan2(R[0, 1], R[0, 0]))
            rotations = np.asarray(rotations)
            for lbl in np.unique(labels):
                sel = labels == lbl
                theta = float(np.median(rotations[sel]))
                if abs(theta) * 180 / np.pi > rotation_threshold:
                    c, s = np.cos(theta), np.sin(theta)
                    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                                 dtype=np.float64)
                    for m, keep in zip(self.meshes, sel):
                        if keep:
                            m.apply_affine(
                                R, gear=(const.MESH_GEAR_MOVING,
                                         const.MESH_GEAR_MOVING))
        bboxes = np.asarray([m.bbox(gear=const.MESH_GEAR_MOVING) for m in self.meshes])
        corner = bboxes[:, :2].min(axis=0)
        shift = np.asarray(offset, np.float64) - corner
        for m in self.meshes:
            m.apply_translation(shift, const.MESH_GEAR_MOVING)
        return shift

    def match_residues(self):
        slm = getattr(self, '_slm', None)
        if slm is None:
            return np.zeros(0)
        return slm.match_residues(gear=const.MESH_GEAR_MOVING)


def subprocess_match_list_of_overlaps(loader_spec, overlaps, margin,
                                      matcher_config, device=None):
    """Match a batch of overlap pairs. Returns a list of ((i, j),
    Match|None, photometric|None, error|None), matches in tile-local
    pixel coordinates. A failure of one overlap's crops, photometrics or
    offsets is recorded in its error slot; errors of the batched match
    itself propagate."""
    from feabas_tpu_torch.matcher import match_pairs_batched
    loader = get_loader_from_json(loader_spec)
    out = []
    jobs = []
    ctx = []
    for i, j in overlaps:
        try:
            bbox_i = loader.bboxes[i]
            bbox_j = loader.bboxes[j]
            ovl, valid = intersect_bbox(bbox_i, bbox_j)
            if not valid:
                out.append(((i, j), None, None, None))
                continue
            ovl_m = common.bbox_enlarge(ovl, margin)
            crop_i, _ = intersect_bbox(ovl_m, bbox_i)
            crop_j, _ = intersect_bbox(ovl_m, bbox_j)
            img_i = loader.crop(crop_i, fileid=i)
            img_j = loader.crop(crop_j, fileid=j)
            mc = dict(matcher_config)
            # stage prior: crop_j's origin in crop_i's frame
            mc.setdefault('stage_prior', (float(crop_j[0] - crop_i[0]),
                                          float(crop_j[1] - crop_i[1])))
            maskout = mc.pop('maskout_val', None)
            if maskout is not None:
                mc['mask0'] = img_i != maskout
                mc['mask1'] = img_j != maskout
            mc.pop('compute_photometric', None)
            jobs.append((img_i, img_j, mc))
            ctx.append(((i, j), bbox_i, bbox_j, ovl, crop_i, crop_j))
        except Exception as e:  # one overlap's failure stays its own
            out.append(((i, j), None, None, f'{type(e).__name__}: {e}'))
    matches = match_pairs_batched(jobs, device=device)
    for match, (key, bbox_i, bbox_j, ovl, crop_i, crop_j) in zip(matches, ctx):
        i, j = key
        try:
            photometric = None
            if matcher_config.get('compute_photometric', False):
                ov_i, _ = intersect_bbox(ovl, crop_i)
                a = loader.crop(ov_i, fileid=i).astype(np.float64)
                b = loader.crop(ov_i, fileid=j).astype(np.float64)
                sel = (a > 0) & (b > 0)
                if sel.sum() > 16:
                    photometric = (float(a[sel].mean()), float(a[sel].std()),
                                   float(b[sel].mean()), float(b[sel].std()))
            if match is not None:
                off_i = np.asarray(crop_i[:2]) - bbox_i[:2]
                off_j = np.asarray(crop_j[:2]) - bbox_j[:2]
                match = Match(match.xy0 + off_i, match.xy1 + off_j,
                              match.weight, match.strain)
            out.append((key, match, photometric, None))
        except Exception as e:
            out.append((key, None, None, f'{type(e).__name__}: {e}'))
    return out


class MontageRenderer:
    """Compose solved tile meshes into output images."""

    def __init__(self, meshes, loader, name='', device=None, **kwargs):
        self.meshes = meshes
        self.loader = loader
        self.name = name
        self.device = device_mod.get_device(device)
        self._blend = str(kwargs.get('blend', 'LINEAR')).upper()
        self._blend_margin = kwargs.get('blend_margin', None)
        self._transfers = kwargs.get('tile_transfers', None)
        self._maskouts = kwargs.get('tile_maskouts', None)
        self._maskout_margin = kwargs.get('maskout_margin', 16.0)
        self._pyramid_sigma = max((self._blend_margin or 16) / 4.0, 2.0)
        self._renderers = [MeshRenderer.from_mesh(m, device=self.device)
                           for m in meshes]
        self._bounds = np.asarray([m.bbox(gear=const.MESH_GEAR_MOVING)
                                   for m in meshes])
        self._index = GridIndex(self._bounds)
        self._tile_sizes = (loader.bboxes[:, 2:] - loader.bboxes[:, :2])
        self._mdev_engine = None

    @classmethod
    def from_stitcher(cls, stitcher, loader_config=None, **kwargs):
        loader = stitcher.loader(**(loader_config or {}))
        kwargs.setdefault('tile_transfers', stitcher.tile_transfers)
        return cls(stitcher.meshes, loader, name=stitcher.name, **kwargs)

    def add_transfer_functions(self, lut, scale=1.0):
        """Per-tile intensity transfer (gain, offset) from a LUT (a dict, or
        the path of its JSON) whose keys are image names: INTERP1D control
        points (``[xp, fp]``) reduce to their least-squares line, so the
        blend stays linear; BRIGHTNESS_CONTRAST_ADJUST gives (brightness,
        contrast) as (offset, gain) directly. Tiles the LUT does not name
        keep (1, 0). The blend reads them per block. Returns the (N, 2)
        transfers."""
        import json
        if isinstance(lut, str):
            with storage.File(lut, 'r') as f:
                lut = json.load(f)
        tf_type = lut.get('__TYPE__', 'INTERP1D')
        transfers = np.tile(np.array([1.0, 0.0]), (len(self.meshes), 1))
        name2idx = {storage.base_name(str(p)): i
                    for i, p in enumerate(self.loader.imgpaths)}
        for nm, vals in lut.items():
            if nm == '__TYPE__':
                continue
            i = name2idx.get(storage.base_name(str(nm)))
            if i is None:
                continue
            if tf_type == 'INTERP1D':
                xp = np.asarray(vals[0], np.float64).ravel()
                fp = np.asarray(vals[1], np.float64).ravel()
                A = np.stack([xp, np.ones_like(xp)], -1)
                g, o = np.linalg.lstsq(A, fp, rcond=None)[0]
            else:
                o, g = float(vals[0]), float(vals[1])
            transfers[i] = (g, o)
        self._transfers = transfers
        return transfers

    @classmethod
    def from_h5(cls, fname, loader_config=None, **kwargs):
        st = Stitcher.from_h5(fname, load_matches=False, load_meshes=True,
                              device=kwargs.get('device', None))
        obj = cls.from_stitcher(st, loader_config=loader_config, **kwargs)
        obj._src_h5 = fname
        obj._loader_config = loader_config
        obj._init_kwargs = dict(kwargs)
        return obj

    @property
    def bounds(self):
        return (self._bounds[:, 0].min(), self._bounds[:, 1].min(),
                self._bounds[:, 2].max(), self._bounds[:, 3].max())

    def _montage_device_engine(self):
        if self._mdev_engine is None:
            from feabas_tpu_torch.ops.montage_render import MontageDeviceEngine
            self._mdev_engine = MontageDeviceEngine(self, self.device)
        return self._mdev_engine

    def crop(self, bbox, **kwargs):
        """Render one output block with tile blending."""
        blend = str(kwargs.pop('blend', self._blend)).upper()
        fillval = kwargs.pop('fillval', self.loader.default_fillval)
        dev_flag = resolve_device_render(kwargs.pop('device_render', None),
                                         self.device)
        hits = self._index.query(bbox)
        xbase = int(np.floor(bbox[0]))
        ybase = int(np.floor(bbox[1]))
        H = int(np.ceil(bbox[3])) - ybase
        W = int(np.ceil(bbox[2])) - xbase
        if hits.size == 0:
            if kwargs.get('return_empty', False):
                return None
            return np.full((H, W), fillval, dtype=self.loader.dtype)
        if dev_flag and set(kwargs) <= {'return_empty'}:
            res = self._montage_device_engine().render_block(
                bbox, hits, blend, float(fillval))
            if res is not NotImplemented:
                if res is None:
                    if kwargs.get('return_empty', False):
                        return None
                    return np.full((H, W), fillval, dtype=self.loader.dtype)
                return res.astype(self.loader.dtype, copy=False)
        return self._crop_host(bbox, hits, blend, fillval, xbase, ybase, H, W,
                               **kwargs)

    def _crop_host(self, bbox, hits, blend, fillval, xbase, ybase, H, W,
                   **kwargs):
        """The host blend (feabas_tpu.stitcher.MontageRenderer.crop)."""
        acc = np.zeros((H, W), np.float32)
        wacc = np.zeros((H, W), np.float32)
        best_w = np.full((H, W), -np.inf, np.float32)
        best_img = np.zeros((H, W), np.float32)
        mn = np.full((H, W), np.inf, np.float32)
        mx = np.full((H, W), -np.inf, np.float32)
        any_mask = np.zeros((H, W), bool)
        pyramid = blend == 'PYRAMID'
        if pyramid:
            import cv2
            acc_low = np.zeros((H, W), np.float32)
            best_high = np.zeros((H, W), np.float32)
        sub_pad = int(np.ceil(4 * self._pyramid_sigma)) + 1 if pyramid else 1
        from feabas_tpu_torch.dal import TileView
        for t in hits:
            tb = self._bounds[int(t)]
            ix0 = max(xbase, int(np.floor(tb[0])) - sub_pad)
            iy0 = max(ybase, int(np.floor(tb[1])) - sub_pad)
            ix1 = min(xbase + W, int(np.ceil(tb[2])) + sub_pad)
            iy1 = min(ybase + H, int(np.ceil(tb[3])) + sub_pad)
            if ix1 <= ix0 or iy1 <= iy0:
                continue
            sl = np.s_[iy0 - ybase:iy1 - ybase, ix0 - xbase:ix1 - xbase]
            r = self._renderers[int(t)]
            map_x, map_y, mask = r.crop_field((ix0, iy0, ix1, iy1))
            if not mask.any():
                continue
            img = common.render_by_subregions(
                map_x, map_y, mask, TileView(self.loader, int(t)),
                dtype_out=np.float32, **kwargs)
            if img is None:
                continue
            if self._transfers is not None:
                g, o = self._transfers[int(t)]
                img = img * np.float32(g) + np.float32(o)
            tw, th = self._tile_sizes[int(t)]
            margin = self._blend_margin
            if margin is None:
                margin = max(min(tw, th) / 16.0, 1.0)
            d = np.minimum.reduce([map_x, tw - map_x, map_y, th - map_y])
            w = np.clip(np.nan_to_num(d, nan=0.0) / margin, 0, 1.0)
            w = np.where(mask, w, 0.0).astype(np.float32)
            if self._maskouts is not None and int(t) in self._maskouts:
                mo = np.asarray(self._maskouts[int(t)])
                sx = np.clip(np.nan_to_num(map_x, nan=0).astype(np.int64),
                             0, mo.shape[1] - 1)
                sy = np.clip(np.nan_to_num(map_y, nan=0).astype(np.int64),
                             0, mo.shape[0] - 1)
                hit = mo[sy, sx] & mask
                if hit.any():
                    from scipy.ndimage import distance_transform_edt
                    dmo = distance_transform_edt(~hit)
                    w = w * np.clip(dmo / max(self._maskout_margin, 1.0),
                                    0.0, 1.0).astype(np.float32)
            m = mask & (w > 0)
            any_mask[sl] |= m
            imgf = img.astype(np.float32)
            acc[sl][m] += imgf[m] * w[m]
            wacc[sl][m] += w[m]
            upd = m & (w > best_w[sl])
            if pyramid:
                mf = m.astype(np.float32)
                low = cv2.GaussianBlur(imgf * mf, (0, 0), self._pyramid_sigma)
                den = cv2.GaussianBlur(mf, (0, 0), self._pyramid_sigma)
                low = np.where(den > 1e-6, low / np.clip(den, 1e-6, None), imgf)
                acc_low[sl][m] += low[m] * w[m]
                best_high[sl][upd] = (imgf - low)[upd]
            best_w[sl][upd] = w[upd]
            best_img[sl][upd] = imgf[upd]
            mn[sl][m] = np.minimum(mn[sl][m], imgf[m])
            mx[sl][m] = np.maximum(mx[sl][m], imgf[m])
        if not any_mask.any() and kwargs.get('return_empty', False):
            return None
        out = np.full((H, W), np.float32(fillval), np.float32)
        if blend == 'PYRAMID':
            nz = wacc > 0
            out[nz] = acc_low[nz] / wacc[nz] + best_high[nz]
        elif blend == 'LINEAR':
            nz = wacc > 0
            out[nz] = acc[nz] / wacc[nz]
        elif blend in ('NEAREST', 'NONE'):
            out[any_mask] = best_img[any_mask]
        elif blend == 'MAX':
            out[any_mask] = mx[any_mask]
        elif blend == 'MIN':
            out[any_mask] = mn[any_mask]
        else:
            raise ValueError(f'unknown blend mode {blend}')
        dtype = self.loader.dtype
        if np.issubdtype(dtype, np.integer):
            info = np.iinfo(dtype)
            out = np.clip(np.round(out), info.min, info.max)
        return out.astype(dtype)

    def generate_roi_mask(self, scale=1.0, canvas_bbox=None):
        """uint8 mask (255 where a tile mesh covers the canvas, else 0) at
        ``scale``, over ``canvas_bbox`` (default the montage bounds),
        rasterized through ``renderer.rasterize_mesh``: pixel (r, c) sits
        at (floor(x0 * scale) + c, floor(y0 * scale) + r) / scale. (The JAX
        package rasterizes from x0 * scale itself, which gives a grid one
        pixel larger than its mask, and fails, where that is not a whole
        number.)"""
        from feabas_tpu_torch.renderer import rasterize_mesh
        if canvas_bbox is None:
            canvas_bbox = self.bounds
        x0, y0, x1, y1 = canvas_bbox
        H = int(np.ceil((y1 - y0) * scale))
        W = int(np.ceil((x1 - x0) * scale))
        cx, cy = np.floor(x0 * scale), np.floor(y0 * scale)
        mask = np.zeros((H, W), bool)
        for m in self.meshes:
            ms = m.copy()
            ms.change_resolution(ms.resolution / max(scale, 1e-9))
            tid = rasterize_mesh(ms, (cx, cy, cx + W, cy + H),
                                 gear=const.MESH_GEAR_MOVING)
            mask |= tid >= 0
        return mask * np.uint8(255)

    def plan_render_series(self, tile_size=(4096, 4096), canvas_bbox=None,
                           one_based=True, pattern='_tr{ROW_IND}-tc{COL_IND}.png',
                           prefix=''):
        """Z-ordered output tile plan: list of (filename, bbox)."""
        if canvas_bbox is None:
            canvas_bbox = self.bounds
        x0 = int(np.floor(canvas_bbox[0]))
        y0 = int(np.floor(canvas_bbox[1]))
        cols = int(np.ceil((canvas_bbox[2] - x0) / tile_size[1]))
        rows = int(np.ceil((canvas_bbox[3] - y0) / tile_size[0]))
        rr, cc = np.meshgrid(np.arange(rows), np.arange(cols))
        rc = np.stack([rr.ravel(), cc.ravel()], -1)
        plan = []
        offset = 1 if one_based else 0
        for r, c in rc[z_order(rc)]:
            bbox = (x0 + c * tile_size[1], y0 + r * tile_size[0],
                    x0 + (c + 1) * tile_size[1], y0 + (r + 1) * tile_size[0])
            fname = prefix + pattern.format(ROW_IND=r + offset, COL_IND=c + offset)
            plan.append((fname, bbox))
        return plan

    def render_tile_list(self, plan, out_dir, **kwargs):
        """Render a list of (filename, bbox) output tiles; existing files
        are skipped. Blocks the device path declines go to the host path
        one by one. Returns the rendered sublist."""
        from feabas_tpu_torch import storage
        rendered = []
        pending = []
        for fname, bbox in plan:
            path = join_paths(out_dir, fname)
            if storage.file_exists(path, use_cache=True):
                rendered.append((fname, bbox))
            else:
                pending.append((fname, bbox, path))
        dev_flag = resolve_device_render(kwargs.get('device_render', None),
                                         self.device)
        dev_results = None
        if pending and dev_flag \
                and set(kwargs) <= {'return_empty', 'device_render'}:
            blend = str(kwargs.get('blend', self._blend)).upper()
            dev_results = self._montage_device_engine().render_blocks(
                [bbox for _, bbox, _ in pending], blend,
                float(self.loader.default_fillval))
        done = {f for f, _ in rendered}
        for k, (fname, bbox, path) in enumerate(pending):
            blk = dev_results[k] if dev_results is not None else NotImplemented
            if blk is NotImplemented:
                blk = self.crop(bbox, return_empty=True, **kwargs)
            elif blk is not None:
                blk = blk.astype(self.loader.dtype, copy=False)
            if blk is None:
                continue
            common.imwrite(path, blk)
            done.add(fname)
        return [(f, b) for f, b in plan if f in done]

    def render_series_to_file(self, out_dir, **kwargs):
        """Render all output tiles as images and write the metadata
        coordinate file. With ``num_workers`` > 1 on the CPU, plan slices
        go to worker processes that rebuild the renderer from its tform
        H5; on a CUDA device everything renders in this process."""
        from feabas_tpu_torch import storage
        tile_size = kwargs.pop('tile_size', (4096, 4096))
        pattern = kwargs.pop('pattern', '_tr{ROW_IND}-tc{COL_IND}.png')
        one_based = kwargs.pop('one_based', True)
        num_workers = int(kwargs.pop('num_workers', 1) or 1)
        prefix = self.name or 'section'
        plan = self.plan_render_series(tile_size=tile_size, pattern=pattern,
                                       one_based=one_based, prefix=prefix,
                                       canvas_bbox=kwargs.pop('canvas_bbox', None))
        src = getattr(self, '_src_h5', None)
        if (num_workers > 1 and src is not None and len(plan) > 1
                and self.device.type != 'cuda'):
            njobs = min(num_workers * 2, len(plan))
            bounds = np.linspace(0, len(plan), njobs + 1).astype(int)
            args = [(src, self._loader_config,
                     getattr(self, '_init_kwargs', {}),
                     plan[a:b], out_dir, dict(kwargs))
                    for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
            rendered = []
            for part in submit_to_workers(subprocess_render_montage_tiles,
                                          args, num_workers=num_workers):
                rendered += part
            rendered.sort(key=lambda fb: fb[0])
        else:
            rendered = self.render_tile_list(plan, out_dir, **kwargs)
        meta_path = join_paths(out_dir, 'metadata.txt')
        with storage.File(meta_path, 'w') as f:
            f.write('{ROOT_DIR}\t' + str(out_dir) + '\n')
            if self.loader.resolution:
                f.write('{RESOLUTION}\t' + str(self.loader.resolution) + '\n')
            for fname, bbox in rendered:
                f.write(f'{fname}\t{bbox[0]}\t{bbox[1]}\t{bbox[2]}\t{bbox[3]}\n')
        return rendered

    def render_series_to_tensorstore(self, out_dir, **kwargs):
        """Render the stitched section into a chunked volume (z-depth 1),
        e.g. neuroglancer_precomputed, through ``dal.TensorStoreWriter``
        (reference driver options: stitcher.py:753-817). Superblocks of
        chunks render through ``crop`` (on a CUDA device, the montage
        blend) and every chunk is written from them. Returns the number of
        chunks written."""
        from feabas_tpu_torch.dal import TensorStoreWriter
        bounds = self.bounds
        canvas = kwargs.pop('canvas_bbox', None) or [
            int(np.floor(bounds[0])), int(np.floor(bounds[1])),
            int(np.ceil(bounds[2])), int(np.ceil(bounds[3]))]
        canvas = [int(v) for v in canvas]
        chunk = list(kwargs.pop('read_chunk_size', (256, 256)))
        jpeg = kwargs.pop('jpeg_compression', False)
        if kwargs.pop('pad_to_tile_size', jpeg):
            # pad the canvas to whole chunks so every (esp. jpeg-encoded)
            # chunk is full-size (reference: stitcher.py:1635,1672-1674)
            canvas[2] = canvas[0] + int(
                np.ceil((canvas[2] - canvas[0]) / chunk[0])) * chunk[0]
            canvas[3] = canvas[1] + int(
                np.ceil((canvas[3] - canvas[1]) / chunk[1])) * chunk[1]
        writer = TensorStoreWriter.create(
            out_dir, canvas, 1,
            driver=kwargs.pop('driver', 'neuroglancer_precomputed'),
            chunk_shape=chunk + [1],
            resolution=self.loader.resolution or config.montage_resolution(),
            thickness=config.section_thickness(),
            jpeg_compression=jpeg)
        # render SUPERBLOCKS of read chunks, then slice chunk writes out of
        # each: per-crop overhead (tile-hit query + per-tile rasterize) is
        # amortized ~superblock_chunks^2 times vs cropping per 256px chunk
        sb = max(int(kwargs.pop('superblock_chunks', 8)), 1)
        fv = kwargs.get('fillval', self.loader.default_fillval)
        # unwritten chunks read back as the driver's missing-chunk value
        # (0), not our render fillval: leaving a chunk sparse is only
        # equivalent to writing it when fillval is 0
        sparse_ok = (fv == 0)
        groups = {}
        for bbox in writer.plan_chunks():
            key = ((bbox[0] - canvas[0]) // (chunk[0] * sb),
                   (bbox[1] - canvas[1]) // (chunk[1] * sb))
            groups.setdefault(key, []).append(bbox)
        n = 0
        for grp in groups.values():
            g = (min(b[0] for b in grp), min(b[1] for b in grp),
                 max(b[2] for b in grp), max(b[3] for b in grp))
            blk = self.crop(g, return_empty=True, **kwargs)
            if blk is None:
                continue
            for bbox in grp:
                sub = blk[bbox[1] - g[1]:bbox[3] - g[1],
                          bbox[0] - g[0]:bbox[2] - g[0]]
                if sparse_ok and not sub.any():
                    continue   # keep all-zero chunks sparse (unwritten)
                writer.write_single_chunk(bbox, 0, sub)
                n += 1
        return n


def subprocess_render_montage_tiles(src_h5, loader_config, init_kwargs, plan,
                                    out_dir, crop_kwargs):
    """Worker: rebuild a MontageRenderer from its tform H5 and render a
    slice of the output-tile plan."""
    mr = MontageRenderer.from_h5(src_h5, loader_config=loader_config,
                                 **(init_kwargs or {}))
    return mr.render_tile_list(plan, out_dir, **(crop_kwargs or {}))
