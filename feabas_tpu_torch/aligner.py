"""Cross-section alignment of the port (counterpart of
``feabas_tpu/aligner.py``).

`Stack` keeps the meshes and matches of a serial stack and relaxes
sliding windows of it; `Aligner` drives the window alignment over the
work dir: meshes in ``mesh_dir``, solved transforms in ``tform_dir``,
matches in ``match_dir``. A tform's existence marks a section as a locked
reference for later runs. A window that packs as a z-chain of linear
meshes is solved as one stacked system on the torch device
(``parallel.window.stack_solve``); other windows take the SLM elastic
solve. Hierarchical chunked alignment (``Aligner._run_chunked``) aligns
chunks of sections, then the chunks as meta-sections, and keeps the same
``chunked_tform/depth{d}/`` files and ``chunk_map.json`` as the JAX
package, so either package resumes what the other wrote.
"""

import os

import numpy as np
import torch

from feabas_tpu_torch import common, config, logging, storage, trace
from feabas_tpu_torch import constant as const
from feabas_tpu_torch.caching import generate_cache
from feabas_tpu_torch.common import Match
from feabas_tpu_torch.mesh import Mesh, transform_mesh
from feabas_tpu_torch.storage import H5File, join_paths
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch import state
from feabas_tpu_torch.optimizer import SLM

DELIMITER = '__to__'

# the window solves run in f32 on the device, as the JAX package does in
# production
SOLVER_DTYPE = torch.float32


@trace.spanned('io.h5')
def read_matches_from_h5(fname, target_resolution=None):
    """Load a match H5 (xy0/xy1/weight/strain/resolution), rescaled to
    ``target_resolution``."""
    with H5File(fname, 'r') as f:
        xy0 = f['xy0'][()]
        xy1 = f['xy1'][()]
        weight = f['weight'][()] if 'weight' in f else np.ones(xy0.shape[0])
        strain = float(f['strain'][()]) if 'strain' in f \
            else config.DEFAULT_AVG_DEFORM
        resolution = float(f['resolution'][()]) if 'resolution' in f \
            else config.montage_resolution()
    if target_resolution is not None and resolution != target_resolution:
        s = resolution / target_resolution
        xy0 = xy0 * s
        xy1 = xy1 * s
    return Match(xy0, xy1, weight, strain)


@trace.spanned('io.h5')
def save_matches_to_h5(fname, match, resolution):
    with H5File(fname, 'w') as f:
        f.create_dataset('xy0', data=match.xy0, compression='gzip')
        f.create_dataset('xy1', data=match.xy1, compression='gzip')
        f.create_dataset('weight', data=match.weight, compression='gzip')
        f.create_dataset('strain', data=float(match.strain))
        f.create_dataset('resolution', data=float(resolution))


def match_name(sec0, sec1, delimiter=DELIMITER):
    return f'{sec0}{delimiter}{sec1}.h5'


def parse_match_name(fname, delimiter=DELIMITER):
    stem = storage.base_name(fname).rsplit('.', 1)[0]
    a, _, b = stem.partition(delimiter)
    return a, b


def get_convex_hull(tname, resolution=None):
    """Convex hull (K, 2) of a saved transform's MOVING vertices."""
    from scipy.spatial import ConvexHull
    m = Mesh.from_h5(tname)
    if resolution is not None:
        m.change_resolution(resolution)
    pts = m.vertices_w_offset(const.MESH_GEAR_MOVING)
    if pts.shape[0] < 3:
        return pts
    return pts[ConvexHull(pts).vertices]


def apply_transform_normalization(tname, out_dir=None, R=None,
                                  txy=(0.0, 0.0), resolution=None):
    """Apply one global rotation + translation to a saved transform's
    FIXED and MOVING gears; writes to ``out_dir`` (default in place)."""
    m = Mesh.from_h5(tname)
    locked = m.locked
    m.locked = False
    if resolution is not None:
        m.change_resolution(resolution)
    T = np.eye(3)
    if R is not None:
        T[:2, :2] = np.asarray(R)[:2, :2]
    T[2, :2] = np.asarray(txy, np.float64)
    for gear in (const.MESH_GEAR_FIXED, const.MESH_GEAR_MOVING):
        if m.vertices_initialized(gear):
            m.apply_affine(T, gear=(gear, gear))
    m.locked = locked
    out = tname if out_dir is None \
        else join_paths(out_dir, storage.base_name(tname))
    m.save_to_h5(out)
    return out


def normalize_transforms(tlist, angle=0.0, offset=(0.0, 0.0), resolution=None,
                         num_workers=1):
    """Rigidly normalize a set of aligned transforms as one stack: rotate
    every section by ``angle`` degrees (None -> the rotation minimizing the
    union bounding rectangle), then shift the stack's bbox corner to
    ``offset`` (None -> rotate about the shared centroid). Returns the
    output canvas bbox (0, 0, W, H)."""
    from feabas_tpu_torch.concurrent import submit_to_workers
    from feabas_tpu_torch.spatial import find_rotation_for_minimum_rectangle
    hulls = list(submit_to_workers(
        get_convex_hull, [(t,) for t in tlist],
        kwargs_list=[{'resolution': resolution}] * len(tlist),
        num_workers=num_workers))
    pts = np.concatenate([h for h in hulls if h is not None and len(h)])

    def rot(th):
        return np.array([[np.cos(th), np.sin(th)],
                         [-np.sin(th), np.cos(th)]])

    if angle is None:
        theta = find_rotation_for_minimum_rectangle(pts.astype(np.float32))
        # keep the derotation direction that zeroes the residual rotation
        res = []
        for th in (theta, -theta):
            r = find_rotation_for_minimum_rectangle(
                (pts @ rot(th)).astype(np.float32))
            res.append(abs((r + np.pi / 4) % (np.pi / 2) - np.pi / 4))
        theta = theta if res[0] <= res[1] else -theta
    else:
        theta = float(angle) * np.pi / 180.0
    Rt = rot(theta)
    tp = pts @ Rt
    cmin, cmax = tp.min(axis=0), tp.max(axis=0)
    if offset is None:
        centr = pts.mean(axis=0)
        txy = centr - centr @ Rt
    else:
        txy = np.asarray(offset, np.float64) - cmin
    xy_max = np.ceil(cmax + txy + np.clip(cmin + txy, 0, None))
    bbox_out = (0, 0, int(xy_max[0]), int(xy_max[1]))
    if theta != 0 or np.any(np.asarray(txy) != 0):
        list(submit_to_workers(
            apply_transform_normalization, [(t,) for t in tlist],
            kwargs_list=[{'R': Rt, 'txy': txy, 'resolution': resolution}]
            * len(tlist), num_workers=num_workers))
    return bbox_out


def match_section_from_initial_matches(match_file, mesh_dir, loaders,
                                       out_dir, **matcher_config):
    """Fine matching between two sections seeded by coarse matches: place
    mesh1 by the affine cascade on the coarse matches, run the section
    matcher and write the match H5. Returns the output path or None."""
    from feabas_tpu_torch.matcher import section_matcher
    sec0, sec1 = parse_match_name(match_file)
    outname = join_paths(out_dir, match_name(sec0, sec1))
    if storage.file_exists(outname, use_cache=True):
        return outname
    resolution = matcher_config.pop('working_resolution',
                                    config.align_resolution())
    coarse = read_matches_from_h5(match_file, target_resolution=resolution)
    mesh0 = Mesh.from_h5(join_paths(mesh_dir, sec0 + '.h5'))
    mesh1 = Mesh.from_h5(join_paths(mesh_dir, sec1 + '.h5'))
    mesh0.change_resolution(resolution)
    mesh1.change_resolution(resolution)
    mesh0.uid, mesh1.uid = 0.0, 1.0
    mesh0.locked = True
    slm = SLM([mesh0, mesh1])
    slm.add_link_from_coordinates(0.0, 1.0, coarse.xy0, coarse.xy1,
                                  weight=coarse.weight)
    slm.optimize_affine_cascade(start_gear=const.MESH_GEAR_INITIAL)
    loader0, loader1 = loaders
    match = section_matcher(mesh0, mesh1, loader0, loader1, **matcher_config)
    if match is None:
        return None
    save_matches_to_h5(outname, match, resolution)
    return outname


class Stack:
    """Section and match bookkeeping of one alignment stack; window solves
    run on ``device`` (default ``FEABAS_TORCH_DEVICE``, else the CUDA
    card)."""

    def __init__(self, section_list=None, match_list=None, **kwargs):
        self.mesh_dir = kwargs.get('mesh_dir', None)
        self.tform_dir = kwargs.get('tform_dir', None)
        self.match_dir = kwargs.get('match_dir', None)
        self.device = device_mod.get_device(kwargs.get('device', None))
        self.mesh_cache = generate_cache('lru', maxlen=kwargs.get(
            'mesh_cache_size', 256))
        self._mesh_overrides = kwargs.get('meshes', None)   # in-memory mode
        self._match_overrides = kwargs.get('matches', None)
        if section_list is None:
            section_list = self._discover_sections()
        self.section_list = list(section_list)
        self._z = {s: z for z, s in enumerate(self.section_list)}
        if match_list is None:
            match_list = self._discover_matches()
        self.match_list = list(match_list)
        self.resolution = kwargs.get('resolution', None) \
            or config.montage_resolution()
        self.last_window_sharded = False

    def _discover_sections(self):
        if self._mesh_overrides is not None:
            return sorted(self._mesh_overrides.keys())
        files = storage.list_folder_content(join_paths(self.mesh_dir, '*.h5'))
        return [storage.base_name(f).rsplit('.', 1)[0] for f in files]

    def _discover_matches(self):
        if self._match_overrides is not None:
            return sorted(self._match_overrides.keys())
        if self.match_dir is None:
            return []
        out = []
        for f in storage.list_folder_content(join_paths(self.match_dir,
                                                        '*.h5')):
            a, b = parse_match_name(f)
            if a in self._z and b in self._z:
                out.append((a, b))
        return out

    @property
    def num_sections(self):
        return len(self.section_list)

    def section_z(self, name):
        return self._z[name]

    def get_mesh(self, name):
        """Load a section mesh; a tform in tform_dir supersedes (and locks)
        the raw mesh."""
        if name in self.mesh_cache:
            return self.mesh_cache[name]
        if self._mesh_overrides is not None:
            mesh = self._mesh_overrides[name]
        else:
            tform = join_paths(self.tform_dir, name + '.h5') \
                if self.tform_dir else None
            if tform and storage.file_exists(tform):
                mesh = Mesh.from_h5(tform)
                mesh.locked = True
            else:
                mesh = Mesh.from_h5(join_paths(self.mesh_dir, name + '.h5'))
                mesh.locked = False
        mesh.change_resolution(self.resolution)
        mesh.uid = float(self._z[name])
        if not mesh.name:
            mesh._name = name
        self.mesh_cache[name] = mesh
        return mesh

    def get_match(self, pair):
        if self._match_overrides is not None:
            return self._match_overrides[pair]
        return read_matches_from_h5(
            join_paths(self.match_dir, match_name(*pair)),
            target_resolution=self.resolution)

    def initialize_SLM(self, sections):
        """An SLM over a window of sections and the links among them."""
        secset = set(sections)
        slm = SLM([self.get_mesh(s) for s in sections], dtype=SOLVER_DTYPE,
                  device=self.device)
        for (a, b) in self.match_list:
            if a in secset and b in secset:
                m = self.get_match((a, b))
                slm.add_link_from_coordinates(
                    float(self._z[a]), float(self._z[b]), m.xy0, m.xy1,
                    weight=m.weight, strain=m.strain,
                    gear=(const.MESH_GEAR_INITIAL, const.MESH_GEAR_INITIAL))
        return slm

    def optimize_section_list(self, sections, **kwargs):
        """Affine cascade + elastic relaxation over a window. Sections
        broken into disconnected pieces split into component meshes (links
        redistributed) and sync back afterwards. A window that packs as a
        z-chain of linear meshes is solved as one stacked system
        (``_sharded_window_solve``); others take ``SLM.optimize_elastic``.

        ``free_sections``: optional set of names left unlocked; the lock
        flags are set here on the fetched meshes."""
        free_sections = kwargs.pop('free_sections', None)
        slm = self.initialize_SLM(sections)
        if free_sections is not None:
            for m in slm.meshes:
                m.locked = m.name not in free_sections
        if np.all(slm.lock_flags):
            return slm
        # sections the matches never tie to an anchor keep their start
        # placement, stay unlocked and are logged
        outcasts = slm.flag_outcasts()
        if outcasts.any():
            names = sorted({m.name for m, o in zip(slm.meshes, outcasts) if o})
            logging.get_main_logger().warning(
                'unanchored section(s) %s: no match path to a locked '
                'mesh; placements withheld', names)
            if outcasts.all():
                return slm
        n_split = slm.divide_disconnected_submeshes()
        residue_mode = kwargs.pop('residue_mode', 'huber')
        residue_len = kwargs.pop('residue_len', -3)
        if residue_len < 0:
            residue_len = abs(residue_len) * config.section_thickness() \
                / self.resolution
        use_sharded = kwargs.pop('use_sharded_solve', True)
        elastic_params = dict(kwargs.pop('elastic_params', {}) or {})
        # callback_settings map onto the CG stall-chances early stop
        cb = elastic_params.pop('callback_settings', None) or {}
        if cb and 'chances' not in elastic_params:
            elastic_params['chances'] = (int(cb.get('chances') or 5)
                                         * int(cb.get('eval_step') or 10))
        elastic_params.pop('precondition', None)
        lam = elastic_params.pop('stiffness_lambda', 1.0)
        slm.optimize_affine_cascade(start_gear=const.MESH_GEAR_FIXED)
        # strain-driven per-mesh soft factors: a section whose matches
        # report heavy distortion absorbs it instead of its neighbours
        soft_power = float(elastic_params.pop('mesh_soft_power', 0) or 0)
        if soft_power > 0:
            mesh_strains = {}
            for lnk in slm.links:
                s = getattr(lnk, 'strain', np.nan)
                if np.isfinite(s):
                    for uid in lnk.uids:
                        mesh_strains.setdefault(uid, []).append(s)
            if mesh_strains:
                mesh_strains = {u: max(float(np.median(v)), 1e-3)
                                for u, v in mesh_strains.items()}
                avg_deform = min(config.DEFAULT_AVG_DEFORM,
                                 3 * float(np.mean(list(mesh_strains.values()))))
                for m in slm.meshes:
                    if not m.locked:
                        m.soft_factor = min(
                            2.0, (avg_deform
                                  / mesh_strains.get(m.uid, avg_deform))
                            ** soft_power)
        done = False
        if use_sharded and not n_split:
            done = self._sharded_window_solve(
                slm, abs(lam), residue_mode, residue_len,
                tol=elastic_params.get('tol', 1e-7),
                maxiter=int(elastic_params.get('maxiter') or 2000))
        if not done:
            slm.optimize_elastic(stiffness_lambda=-abs(lam),
                                 crosslink_lambda=-1.0,
                                 residue_mode=residue_mode,
                                 residue_len=residue_len,
                                 **elastic_params)
        if n_split:
            slm.sync_component_positions()
        return slm

    def _sharded_window_solve(self, slm, lam_ratio, residue_mode,
                              residue_len, tol=1e-7, maxiter=2000,
                              max_passes=3):
        """Solve one window as the stacked z-chain system on this stack's
        device (one device: the stack is not sharded); returns False when
        the window does not pack as a z-chain. Robust residue reweighting
        runs on the host between passes. Sets ``last_window_sharded``."""
        from feabas_tpu_torch.parallel.window import (
            build_link_transpose, pad_stack_sections, slm_window_to_stack,
            stack_positions, stack_rigid_modes, stack_solve)
        system = slm_window_to_stack(slm)
        if system is None:
            return False
        system = pad_stack_sections(system, 1)
        S = system['u'].shape[0]
        # topology-static link transpose: weights change per pass, link
        # indices never do
        system['linc'] = build_link_transpose(
            system['links'], S, system['u'].shape[1])
        base_weight = system['links'][4].copy()
        u = system['u']
        for _pass in range(max(int(max_passes), 1)):
            # recompute per pass: reweighting can split the chain into new
            # fully free components whose rigid modes must deflate too
            modes = stack_rigid_modes(system)
            t = state.window_system_to_device(system, self.device,
                                              SOLVER_DTYPE)
            out, n_it, res = stack_solve(
                t['verts0'], t['u'], t['tris'], t['multiplier'],
                t['poisson'], t['links'], t['r_rest'], t['free'], tol=tol,
                maxiter=maxiter,
                modes=None if modes is None else state.to_tensors(
                    modes, self.device, SOLVER_DTYPE),
                lam_ratio=float(lam_ratio),
                grid_shape=system.get('grid_shape'), linc=t.get('linc'),
                sten=t.get('sten'))
            u = out.cpu().numpy().astype(np.float64)
            system['u'] = u.astype(np.float32)
            if residue_mode is None or not residue_len or residue_len <= 0:
                break
            new_w = _robust_link_weights(system, u, base_weight,
                                         residue_mode, residue_len)
            weight = system['links'][4]
            if np.allclose(new_w, weight, atol=1e-6):
                break
            system['links'] = system['links'][:4] + (new_w,)
        # commit MOVING positions of the free meshes (world frame, f64)
        for k, (m, mv) in enumerate(zip(slm.meshes,
                                        stack_positions(system, u))):
            if m.locked:
                continue
            c = mv.mean(axis=0, keepdims=True)
            m.set_vertices(mv - c, const.MESH_GEAR_MOVING, offset=c)
        # carry the robust weights back to the SLM links for residue reports
        if residue_mode and residue_len and residue_len > 0:
            for l in slm.active_links():
                l.adjust_weight_from_residue(gear=const.MESH_GEAR_MOVING,
                                             residue_len=residue_len,
                                             residue_mode=residue_mode)
        self.last_window_sharded = True
        return True

    def optimize_slide_window(self, **kwargs):
        """Sliding-window relaxation over the whole stack: windows of
        ``window_size + buffer_size`` slide from ``start_loc``; sections at
        least ``buffer_size`` from an open window edge commit (and lock),
        the buffer re-relaxes in the next window. A ``parallel_framework``
        hands each window to a worker through the work dir. Returns the
        committed sections."""
        window_size = int(kwargs.pop('window_size', 64))
        buffer_size = int(kwargs.pop('buffer_size', 16))
        start_loc = str(kwargs.pop('start_loc', 'M')).upper()
        commit_fn = kwargs.pop('commit_fn', None)
        dispatch = kwargs.pop('parallel_framework', None)
        dispatch_settings = kwargs.pop('dispatch_settings', {}) or {}
        n = self.num_sections
        committed = np.asarray([self.get_mesh(s).locked
                                for s in self.section_list])
        out = []
        total = max(window_size + buffer_size, 2)

        def do_commit(i):
            name = self.section_list[i]
            mesh = self.get_mesh(name)
            committed[i] = True
            if getattr(mesh, 'is_outcast', False):
                return      # unanchored: leave unlocked, persist nothing
            mesh.locked = True
            out.append(name)
            if commit_fn is not None:
                commit_fn(name, mesh)

        while not committed.all():
            unc = np.nonzero(~committed)[0]
            if committed.any():
                # the uncommitted section nearest committed territory; the
                # window hugs the committed side for context
                comm = np.nonzero(committed)[0]
                dists = np.min(np.abs(unc[:, None] - comm[None, :]), axis=1)
                i = int(unc[np.argmin(dists)])
                if committed[max(i - 1, 0)] or i == 0:
                    lo = max(0, i - buffer_size)
                else:
                    lo = max(0, min(i + buffer_size + 1, n) - total)
            elif start_loc == 'L':
                lo = 0
            elif start_loc == 'R':
                lo = max(0, n - total)
            else:
                lo = max(0, (n - total) // 2)
            hi = min(lo + total, n)
            win = list(range(lo, hi))
            # an edge is open when uncommitted sections lie beyond it
            open_left = (lo > 0) and not committed[:lo].all()
            open_right = (hi < n) and not committed[hi:].all()
            commit_set = [k for k in win if not committed[k]
                          and not (open_left and k < lo + buffer_size)
                          and not (open_right and k >= hi - buffer_size)]
            if not commit_set:
                # degenerate window: commit the section farthest from any
                # open edge to guarantee progress
                cand = [k for k in win if not committed[k]]
                score = [min(k - lo if open_left else n,
                             hi - 1 - k if open_right else n) for k in cand]
                commit_set = [cand[int(np.argmax(score))]]
            win_names = [self.section_list[k] for k in win]
            if dispatch and self.mesh_dir is not None:
                from feabas_tpu_torch.concurrent import submit_to_workers
                commit_names = [self.section_list[k] for k in commit_set]
                job = (_stack_init_dict(self), win_names, commit_names,
                       dict(kwargs))
                result = list(submit_to_workers(
                    subprocess_optimize_window, [job], num_workers=1,
                    parallel_framework=dispatch, **dispatch_settings))[0]
                storage.clear_exists_cache()
                saved = set(result)
                for k, name in zip(commit_set, commit_names):
                    self.mesh_cache.pop(name)
                    committed[k] = True
                    if name not in saved:
                        continue    # withheld (unanchored): retries later
                    out.append(name)
                    if commit_fn is not None:
                        commit_fn(name, self.get_mesh(name))
                continue
            self.optimize_section_list(win_names, **dict(kwargs))
            for k in commit_set:
                do_commit(k)
        return out


def _robust_link_weights(system, u, base_weight, residue_mode, residue_len):
    """Robust (huber / threshold / huber_smooth) link weights of a solved
    stacked system, from the residues at displacement ``u`` (host)."""
    idx0, bary0, idx1, bary1, weight = system['links']
    S = u.shape[0]
    U0 = np.einsum('klc,klcd->kld', bary0,
                   u[:-1][np.arange(S - 1)[:, None, None], idx0])
    U1 = np.einsum('klc,klcd->kld', bary1,
                   u[1:][np.arange(S - 1)[:, None, None], idx1])
    dxy = system['r_rest'].astype(np.float64) + U1 - U0
    if residue_mode == 'huber_smooth':
        # damp by the deviation from the locally coherent residue field
        # (Link.dxy_smoothen on the stacked arrays)
        from scipy.spatial import cKDTree
        for k in range(S - 1):
            wk = weight[k]
            ok = wk > 0
            if ok.sum() < 4:
                continue
            p = (system['verts0_host'][k][idx0[k][ok]]
                 * bary0[k][ok][..., None].astype(np.float64)).sum(1)
            tree = cKDTree(p)
            dnn, _ = tree.query(p, k=2)
            sig = 3.0 * max(float(np.median(dnn[:, 1])), 1e-6)
            pairs = tree.query_pairs(2.5 * sig, output_type='ndarray')
            sm = np.zeros_like(dxy[k][ok])
            wv = np.zeros(ok.sum())
            if pairs.size:
                gw = np.exp(-np.sum((p[pairs[:, 0]] - p[pairs[:, 1]]) ** 2,
                                    axis=-1) / sig ** 2)
                dk = dxy[k][ok]
                wk_ok = wk[ok]
                np.add.at(sm, pairs[:, 0],
                          gw[:, None] * dk[pairs[:, 1]] * wk_ok[pairs[:, 1], None])
                np.add.at(sm, pairs[:, 1],
                          gw[:, None] * dk[pairs[:, 0]] * wk_ok[pairs[:, 0], None])
                np.add.at(wv, pairs[:, 0], gw * wk_ok[pairs[:, 1]])
                np.add.at(wv, pairs[:, 1], gw * wk_ok[pairs[:, 0]])
            good = wv > 0
            sm[good] /= wv[good, None]
            dxy[k][np.nonzero(ok)[0]] -= sm
    r = np.linalg.norm(dxy, axis=-1)
    if residue_mode == 'threshold':
        f = (r <= residue_len).astype(np.float32)
    else:  # huber / huber_smooth
        f = np.clip(residue_len / np.clip(r, 1e-9, None),
                    None, 1.0).astype(np.float32)
    return base_weight * f


def _stack_init_dict(stack):
    """Picklable spec to rebuild a Stack in a worker."""
    return {'section_list': list(stack.section_list),
            'mesh_dir': stack.mesh_dir, 'tform_dir': stack.tform_dir,
            'match_dir': stack.match_dir, 'resolution': stack.resolution,
            'device': str(stack.device)}


def subprocess_optimize_stack(init_dict, slide_kwargs):
    """Worker: rebuild a Stack and run its sliding window, committing tforms
    to disk. Returns the committed section names."""
    stack = Stack(**init_dict)

    def commit(name, mesh):
        mesh.save_to_h5(join_paths(stack.tform_dir, name + '.h5'))

    return stack.optimize_slide_window(commit_fn=commit, **slide_kwargs)


def subprocess_optimize_window(init_dict, window_sections, commit_sections,
                               opt_kwargs):
    """Worker for one window handed off by ``optimize_slide_window``:
    rebuild the Stack from the work dir (sections with tforms load locked),
    relax the window and commit the decided set. Returns the committed
    names."""
    init_dict = dict(init_dict)
    init_dict.pop('section_list', None)
    stack = Stack(section_list=list(window_sections), **init_dict)
    stack.optimize_section_list(list(window_sections), **dict(opt_kwargs))
    done = []
    for name in commit_sections:
        mesh = stack.get_mesh(name)
        if getattr(mesh, 'is_outcast', False):
            continue
        mesh.save_to_h5(join_paths(stack.tform_dir, name + '.h5'))
        done.append(name)
    return done


def split_disconnected_sections(stack):
    """Partition sections into connected components of the match graph."""
    import scipy.sparse as sparse
    import scipy.sparse.csgraph as csgraph
    n = stack.num_sections
    rows = [stack.section_z(a) for a, b in stack.match_list]
    cols = [stack.section_z(b) for a, b in stack.match_list]
    g = sparse.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    _, labels = csgraph.connected_components(g, directed=False)
    return [[stack.section_list[i] for i in np.nonzero(labels == lbl)[0]]
            for lbl in np.unique(labels)]


class Aligner:
    """Drives window alignment of the stack in the work dir; its stacks
    solve on ``device`` (default ``FEABAS_TORCH_DEVICE``, else the CUDA
    card)."""

    def __init__(self, mesh_dir, tform_dir, match_dir, **kwargs):
        self.mesh_dir = mesh_dir
        self.tform_dir = tform_dir
        self.match_dir = match_dir
        self.section_order_file = kwargs.get('section_order_file', None)
        self.resolution = kwargs.get('resolution', None)
        self.logger = kwargs.get('logger', None)
        self.device = device_mod.get_device(kwargs.get('device', None))

    def get_section_list(self):
        files = storage.list_folder_content(join_paths(self.mesh_dir, '*.h5'))
        names = [storage.base_name(f).rsplit('.', 1)[0] for f in files]
        names, _ = common.rearrange_section_order(names,
                                                  self.section_order_file)
        return names

    def run(self, **kwargs):
        """Align the stack: chunked_to_depth 0 runs the sliding window, more
        the hierarchical chunking of ``_run_chunked``."""
        chunk_settings = kwargs.pop('chunk_settings', {}) or {}
        depth = int(chunk_settings.get('chunked_to_depth', 0))
        slide = dict(kwargs.pop('slide_window', {}) or {})
        if depth > 0:
            return self._run_chunked(slide, chunk_settings, **kwargs)
        return self._run_window(slide, **kwargs)

    def _run_window(self, slide, num_workers=1, **kwargs):
        from feabas_tpu_torch.concurrent import REMOTE_FRAMEWORKS
        slide = dict(slide)
        if (slide.get('parallel_framework') is None
                and config.parallel_framework() in REMOTE_FRAMEWORKS):
            slide['parallel_framework'] = config.parallel_framework()
        sections = self.get_section_list()
        stack = Stack(section_list=sections, mesh_dir=self.mesh_dir,
                      tform_dir=self.tform_dir, match_dir=self.match_dir,
                      resolution=self.resolution, device=self.device)
        components = split_disconnected_sections(stack)
        committed = []
        if len(components) > 1 and num_workers > 1:
            # link-disconnected components are independent: fan them out
            from feabas_tpu_torch.concurrent import submit_to_workers
            fw = slide.pop('parallel_framework', None)
            args = []
            for comp in components:
                sub = Stack(section_list=comp, mesh_dir=self.mesh_dir,
                            tform_dir=self.tform_dir, match_dir=self.match_dir,
                            resolution=self.resolution, device=self.device)
                args.append((_stack_init_dict(sub), dict(slide)))
            for result in submit_to_workers(subprocess_optimize_stack, args,
                                            num_workers=num_workers,
                                            parallel_framework=fw):
                committed += result
            storage.clear_exists_cache()
        else:
            def commit(name, mesh):
                mesh.save_to_h5(join_paths(self.tform_dir, name + '.h5'))
                storage.clear_exists_cache()

            for comp in components:
                sub = Stack(section_list=comp, mesh_dir=self.mesh_dir,
                            tform_dir=self.tform_dir, match_dir=self.match_dir,
                            resolution=self.resolution, device=self.device)
                committed += sub.optimize_slide_window(commit_fn=commit,
                                                       **slide)
        if self.logger:
            self.logger.info(f'aligned {len(committed)} section(s)')
        return committed

    def _chunk_dirs(self, depth):
        """Work-dir layout of one chunking level:
        ``<tform_dir>/../chunked_tform/depth{depth}/`` with the chunk tforms,
        meta meshes, meta matches and meta tforms."""
        base = join_paths(os.path.dirname(self.tform_dir.rstrip('/')),
                          'chunked_tform', f'depth{depth}')
        dirs = {k: join_paths(base, k) for k in
                ('chunk_tform', 'meta_mesh', 'meta_match', 'meta_tform')}
        for d in dirs.values():
            storage.makedirs(d)
        dirs['root'] = base
        return dirs

    def _update_chunk_map(self, sections, chunk_size, map_path, dirs):
        """Load, repair and extend the persistent chunk map.

        Existing chunks keep their membership and names so their
        file-based resume stays valid when the dataset grows. New
        sections that APPEND (come after every mapped section) pack into
        fresh chunks; sections INSERTED between mapped ones join their
        predecessor's chunk (which then re-runs pass 1 with the old
        members locked). Chunks whose membership changed (or whose
        members disappeared) have their stale meta artifacts deleted.
        Returns (chunks, chunk_names, committed_flags): ``committed``
        marks chunks fully processed (passes 4+5) in a prior run with
        unchanged membership; those skip the predeform rewrite.
        """
        import json
        prev = []
        if storage.file_exists(map_path):
            with storage.File(map_path, 'r') as f:
                prev = json.load(f).get('chunks', [])
        secset = set(sections)
        order = {s: i for i, s in enumerate(sections)}
        chunks, names, flags = [], [], []
        invalidated = []
        mapped = set()
        max_idx = -1
        for ent in prev:
            mem = [s for s in ent['sections'] if s in secset]
            if not mem:
                invalidated.append(ent['name'])
                continue
            chunks.append(list(mem))
            names.append(ent['name'])
            flags.append(bool(ent.get('committed'))
                         and mem == ent['sections'])
            if mem != ent['sections']:
                invalidated.append(ent['name'])
            mapped.update(mem)
            try:
                max_idx = max(max_idx, int(ent['name'][5:]))
            except (ValueError, IndexError):
                pass
        last_mapped = max((order[s] for s in mapped), default=-1)
        new_secs = [s for s in sections if s not in mapped]
        inserted = [s for s in new_secs if order[s] <= last_mapped]
        appended = [s for s in new_secs if order[s] > last_mapped]
        for s in inserted:
            # join the chunk holding the nearest mapped predecessor
            best_k, best_o = 0, -1
            for k, chunk in enumerate(chunks):
                for t in chunk:
                    if best_o < order[t] < order[s]:
                        best_k, best_o = k, order[t]
            chunks[best_k].append(s)
            chunks[best_k].sort(key=order.get)
            flags[best_k] = False
            if names[best_k] not in invalidated:
                invalidated.append(names[best_k])
        for i in range(0, len(appended), chunk_size):
            max_idx += 1
            chunks.append(appended[i:i + chunk_size])
            names.append(f'chunk{max_idx:05d}')
            flags.append(False)
        # z-sort so meta-section names enumerate in stack order
        z0 = [min(order[s] for s in c) for c in chunks]
        srt = np.argsort(z0)
        chunks = [chunks[i] for i in srt]
        names = [names[i] for i in srt]
        flags = [flags[i] for i in srt]
        for cname in invalidated:
            for path in (join_paths(dirs['meta_mesh'], cname + '.h5'),
                         join_paths(dirs['meta_tform'], cname + '.h5')):
                if storage.file_exists(path):
                    storage.remove_file(path)
            for f in storage.list_folder_content(
                    join_paths(dirs['meta_match'], '*.h5')):
                if cname in storage.base_name(f):
                    storage.remove_file(f)
        self._save_chunk_map(map_path, chunks, names, flags)
        storage.clear_exists_cache()
        return chunks, names, flags

    @staticmethod
    def _save_chunk_map(map_path, chunks, names, flags):
        import json
        with storage.File(map_path, 'w') as f:
            json.dump({'chunks': [
                {'name': n, 'sections': list(c), 'committed': bool(fl)}
                for n, c, fl in zip(names, chunks, flags)]}, f, indent=1)

    @staticmethod
    def _merge_chunked_meshes(member_meshes, name, uid, resolution):
        """One meta-section mesh covering the union of a chunk's
        (chunk-aligned, MOVING gear) member meshes at equivalent density
        """
        bbs = np.stack([m.bbox(gear=const.MESH_GEAR_MOVING)
                        for m in member_meshes])
        bb = (bbs[:, 0].min(), bbs[:, 1].min(),
              bbs[:, 2].max(), bbs[:, 3].max())
        area = sum(float(np.abs(m.triangle_areas(
            const.MESH_GEAR_MOVING, signed=False)).sum())
            for m in member_meshes)
        ntri = sum(m.num_triangles for m in member_meshes)
        mesh_size = max(2.0 * (area / max(ntri, 1)) ** 0.5,
                        (bb[2] - bb[0]) / 64, 1.0)
        return Mesh.from_bbox(bb, cartesian=True, mesh_size=mesh_size,
                              name=name, uid=uid, resolution=resolution)

    @staticmethod
    def _merge_chunked_matches(pair_matches):
        """Map cross-chunk section matches through the chunk tforms into
        chunk-aligned (MOVING) coordinates and concatenate them into one
        meta match."""
        XY0, XY1, WTS, STRNS = [], [], [], []
        for match, m0, m1, flipped in pair_matches:
            tid0 = m0.tri_finder(match.xy0, gear=const.MESH_GEAR_INITIAL,
                                 extrapolate=True)
            tid1 = m1.tri_finder(match.xy1, gear=const.MESH_GEAR_INITIAL,
                                 extrapolate=True)
            xy0 = m0.bary2cart(tid0, m0.cart2bary(
                match.xy0, tid0, gear=const.MESH_GEAR_INITIAL),
                gear=const.MESH_GEAR_MOVING)
            xy1 = m1.bary2cart(tid1, m1.cart2bary(
                match.xy1, tid1, gear=const.MESH_GEAR_INITIAL),
                gear=const.MESH_GEAR_MOVING)
            if flipped:
                xy0, xy1 = xy1, xy0
            XY0.append(xy0)
            XY1.append(xy1)
            WTS.append(match.weight)
            STRNS.append((match.strain, float(np.sum(match.weight))))
        if not XY0:
            return None
        STRNS = np.asarray(STRNS)
        wsum = STRNS[:, 1].sum()
        strain = float((STRNS[:, 0] * STRNS[:, 1]).sum() / max(wsum, 1e-12))
        return Match(np.concatenate(XY0), np.concatenate(XY1),
                     np.concatenate(WTS), strain)

    def _run_chunked(self, slide, chunk_settings, **kwargs):
        """Hierarchical chunked alignment:

        1. window-align each chunk of sections independently (free
           floating, committed to a chunk-tform dir);
        2. merge each chunk into a META-SECTION: one mesh over the union
           of its chunk-aligned members + cross-chunk matches mapped
           through the chunk tforms;
        3. recursively align the meta-sections with stiffness scaled by
           the mean chunk size (depth-1 recursion of Aligner.run);
        4. PREDEFORM: resample every member section through its chunk's
           solved meta deformation (transform_mesh);
        5. re-relax junctional neighborhoods elastically with
           non-junctional sections locked (second smooth).
        """
        depth = int(chunk_settings.get('chunked_to_depth', 1))
        chunk_size = int(chunk_settings.get('default_chunk_size', 16))
        junction_width = chunk_settings.get('junction_width', 0.2)
        sections = self.get_section_list()
        if junction_width < 1:
            junction_width = max(int(round(junction_width * chunk_size)), 1)
        junction_width = int(junction_width)
        if chunk_size >= len(sections) or len(sections) <= 2:
            return self._run_window(slide, **kwargs)
        dirs = self._chunk_dirs(depth)
        # PERSISTENT chunk map: chunk membership is decided once and saved
        # beside the chunk tforms, so appending sections to a partially
        # aligned stack keeps existing chunk boundaries (and their
        # file-based resume) stable
        map_path = join_paths(dirs['root'], 'chunk_map.json')
        chunks, chunk_names, chunk_done = self._update_chunk_map(
            sections, chunk_size, map_path, dirs)
        chunk_of = {s: k for k, chunk in enumerate(chunks) for s in chunk}
        committed = []
        # ---- pass 1: align within chunks (free-floating; resume by file) ----
        for chunk in chunks:
            if all(storage.file_exists(join_paths(dirs['chunk_tform'], s + '.h5'),
                                       use_cache=True) for s in chunk):
                continue
            stack = Stack(section_list=chunk, mesh_dir=self.mesh_dir,
                          tform_dir=dirs['chunk_tform'],
                          match_dir=self.match_dir,
                          resolution=self.resolution, device=self.device)

            def commit(name, mesh):
                mesh.save_to_h5(join_paths(dirs['chunk_tform'], name + '.h5'))
                storage.clear_exists_cache()

            stack.optimize_slide_window(commit_fn=commit, **dict(slide))
        chunk_stack = Stack(section_list=sections, mesh_dir=self.mesh_dir,
                            tform_dir=dirs['chunk_tform'],
                            match_dir=self.match_dir,
                            resolution=self.resolution, device=self.device)
        # ---- pass 2: meta-section meshes + matches ----
        for k, (chunk, cname) in enumerate(zip(chunks, chunk_names)):
            out = join_paths(dirs['meta_mesh'], cname + '.h5')
            if storage.file_exists(out, use_cache=True):
                continue
            members = [chunk_stack.get_mesh(s) for s in chunk]
            meta = self._merge_chunked_meshes(members, cname, float(k),
                                              self.resolution
                                              or chunk_stack.resolution)
            meta.save_to_h5(out)
        meta_pairs = {}
        for (a, b) in chunk_stack.match_list:
            ka, kb = chunk_of.get(a), chunk_of.get(b)
            if ka is None or kb is None or ka == kb:
                continue
            flipped = ka > kb
            key = (min(ka, kb), max(ka, kb))
            meta_pairs.setdefault(key, []).append(
                (chunk_stack.get_match((a, b)), chunk_stack.get_mesh(a),
                 chunk_stack.get_mesh(b), flipped))
        for (ka, kb), plist in meta_pairs.items():
            out = join_paths(dirs['meta_match'],
                             match_name(chunk_names[ka], chunk_names[kb]))
            if storage.file_exists(out, use_cache=True):
                continue
            merged = self._merge_chunked_matches(plist)
            if merged is not None:
                save_matches_to_h5(out, merged,
                                   chunk_stack.resolution)
        # ---- pass 3: recursive meta alignment, stiffness scaled by the
        # mean chunk size ----
        mean_cnt = float(np.mean([len(c) for c in chunks]))
        meta_slide = dict(slide)
        ep = dict(meta_slide.get('elastic_params', {}) or {})
        ep['stiffness_lambda'] = abs(ep.get('stiffness_lambda', 1.0)) * mean_cnt
        meta_slide['elastic_params'] = ep
        meta_aligner = Aligner(dirs['meta_mesh'], dirs['meta_tform'],
                               dirs['meta_match'],
                               resolution=self.resolution,
                               logger=self.logger, device=self.device)
        meta_aligner.run(slide_window=meta_slide,
                         chunk_settings={**chunk_settings,
                                         'chunked_to_depth': depth - 1})
        # ---- pass 4: predeform member sections through the solved meta
        # deformation ----
        for k, (chunk, cname) in enumerate(zip(chunks, chunk_names)):
            if chunk_done[k] and all(storage.file_exists(
                    join_paths(self.tform_dir, s + '.h5'), use_cache=True)
                    for s in chunk):
                continue   # committed in a prior run, membership unchanged
            meta_tf = join_paths(dirs['meta_tform'], cname + '.h5')
            if not storage.file_exists(meta_tf):
                if self.logger:
                    self.logger.warning(f'meta tform missing: {meta_tf}')
                continue
            carrier = Mesh.from_h5(meta_tf)
            carrier.change_resolution(chunk_stack.resolution)
            for s in chunk:
                mesh = chunk_stack.get_mesh(s)
                probe = mesh.copy()
                probe.set_vertices(mesh.vertices(const.MESH_GEAR_MOVING),
                                   const.MESH_GEAR_FIXED,
                                   offset=mesh.offset(const.MESH_GEAR_MOVING))
                warped = transform_mesh(
                    probe, carrier,
                    gear=(const.MESH_GEAR_FIXED, const.MESH_GEAR_MOVING))
                mv = warped.vertices_w_offset(const.MESH_GEAR_MOVING)
                c = mv.mean(axis=0, keepdims=True)
                out_mesh = mesh.copy()
                out_mesh.set_vertices(mv - c, const.MESH_GEAR_MOVING, offset=c)
                out_mesh.locked = True
                out_mesh.save_to_h5(join_paths(self.tform_dir, s + '.h5'))
                committed.append(s)
        storage.clear_exists_cache()
        # ---- pass 5: second smooth: elastic re-relaxation of junctional
        # neighborhoods with everything else locked ----
        final_stack = Stack(section_list=sections, mesh_dir=self.mesh_dir,
                            tform_dir=self.tform_dir,
                            match_dir=self.match_dir,
                            resolution=self.resolution, device=self.device)
        for k in range(1, len(chunks)):
            if chunk_done[k - 1] and chunk_done[k]:
                continue   # junction smoothed in a prior run
            junction = (chunks[k - 1][-junction_width:]
                        + chunks[k][:junction_width])
            # pad_junctional: include one locked context section on each
            # side so the free sections relax against committed anchors
            pad = 1 if chunk_settings.get('pad_junctional', True) else 0
            lo = max(sections.index(junction[0]) - pad, 0)
            hi = min(sections.index(junction[-1]) + 1 + pad, len(sections))
            window = sections[lo:hi]
            if len(window) < 3:
                continue
            final_stack.optimize_section_list(
                window, free_sections=set(junction), **dict(slide))
            for s in junction:
                mesh = final_stack.get_mesh(s)
                mesh.save_to_h5(join_paths(self.tform_dir, s + '.h5'))
                mesh.locked = True
            storage.clear_exists_cache()
        # the whole cascade completed: mark every chunk committed so a
        # re-run (incl. after appending sections) skips finished work
        self._save_chunk_map(map_path, chunks, chunk_names,
                             [True] * len(chunks))
        return committed

    def write_residue_file(self, out_csv):
        """Per-pair residue report (median, p90 and max residue)."""
        from feabas_tpu_torch.optimizer import Link
        sections = self.get_section_list()
        stack = Stack(section_list=sections, mesh_dir=self.mesh_dir,
                      tform_dir=self.tform_dir, match_dir=self.match_dir,
                      resolution=self.resolution, device=self.device)
        rows = ['sec0,sec1,num_matches,residue_median,residue_p90,residue_max']
        for pair in stack.match_list:
            try:
                m0 = stack.get_mesh(pair[0])
                m1 = stack.get_mesh(pair[1])
                match = stack.get_match(pair)
                link = Link.from_coordinates(m0, m1, match.xy0, match.xy1,
                                             weight=match.weight)
                r = link.residues(gear=const.MESH_GEAR_MOVING)
                rows.append(f'{pair[0]},{pair[1]},{len(r)},'
                            f'{np.median(r):.3f},{np.quantile(r, 0.9):.3f},'
                            f'{r.max():.3f}')
            except Exception as e:
                rows.append(f'{pair[0]},{pair[1]},error,{e},,')
        with storage.File(out_csv, 'w') as f:
            f.write('\n'.join(rows) + '\n')
        return out_csv
