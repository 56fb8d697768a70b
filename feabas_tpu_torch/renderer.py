"""Mesh rendering of the port (counterpart of ``feabas_tpu/renderer.py``).

``MeshRenderer`` subclasses ``feabas_tpu.renderer.MeshRenderer``: the
host path (rasterize, field, cv2 remap, affine short-circuit) is the JAX
package's own code, and the methods that reach a device are overridden to
use the port's ``ops.render.DeviceRenderEngine`` and ``ops.link_probe``.
The base ``_crop_device_multi``, ``crop`` and ``crop_multiple`` reach the
device only through those overrides, so they are inherited as they are.
``VolumeRenderer`` (tensorstore volumes) is not ported.
"""

import threading

import numpy as np

from feabas_tpu import common, storage
from feabas_tpu import constant as const
from feabas_tpu.common import z_order
from feabas_tpu.renderer import (MeshRenderer as _HostMeshRenderer,
                                 _complete_mip_tuple, _host_mip_tuple,
                                 _write_mip_metadata)
from feabas_tpu_torch import device as device_mod


def resolve_device_render(flag, device):
    """Resolve a per-call device_render flag against the compute device.

    None defers to general_configs ``device.render``. Returns False (host
    path), True (pure device) or 'hybrid' (host and device lanes drain one
    work queue), as ``feabas_tpu.renderer.resolve_device_render`` does:
    'auto' is 'hybrid' when ``device`` is a CUDA device and the host path
    otherwise.
    """
    if flag is None:
        from feabas_tpu import config
        flag = config.device_render()
    if isinstance(flag, str):
        f = flag.strip().lower()
        if f == 'auto':
            return 'hybrid' if device.type == 'cuda' else False
        if f == 'hybrid':
            return 'hybrid'
        return f in ('true', 'on', 'device', '1')
    return bool(flag)


class MeshRenderer(_HostMeshRenderer):
    """Inverse-warp engine for one mesh, rendering on ``device`` (a torch
    device or name; default ``FEABAS_TORCH_DEVICE``/auto)."""

    def __init__(self, mesh, image_loader=None,
                 gear=(const.MESH_GEAR_MOVING, const.MESH_GEAR_INITIAL),
                 device=None, **kwargs):
        super().__init__(mesh, image_loader=image_loader, gear=gear, **kwargs)
        self.device = device_mod.get_device(device)

    def _device_render_requested(self, kwargs):
        return resolve_device_render(kwargs.pop('device_render', None),
                                     self.device)

    def _device_render_ok(self, loader, kwargs):
        """The device raster covers single-channel sources, LINEAR
        interpolation and u8/u16/f32 output without a host-side DoG."""
        import cv2
        from feabas_tpu_torch.ops.render import _out_kind
        if kwargs.get('log_sigma', 0):
            return False
        if kwargs.get('interpolation', cv2.INTER_LINEAR) != cv2.INTER_LINEAR:
            return False
        nc = getattr(loader, 'number_of_channels', None)
        if nc and nc > 1:
            return False
        dtype_out = kwargs.get('dtype_out', getattr(loader, 'dtype',
                                                    np.uint8))
        if _out_kind(dtype_out) is None:
            return False
        if self._fold_sheets is not None and len(self._fold_sheets) > 30:
            return False
        return True

    def _get_device_engine(self):
        if self._dev_engine is None:
            from feabas_tpu_torch.ops.render import DeviceRenderEngine
            colors = None
            if self._geodesic_mask and self._fold_sheets is not None:
                colors = np.full(len(self._mesh.triangles), -1, np.int64)
                for i, tris in enumerate(self._fold_sheets):
                    colors[tris] = i
            self._dev_engine = DeviceRenderEngine(
                self._mesh, self._target_gear, self._source_gear,
                self._tri_render_weight, colors=colors, device=self.device)
        return self._dev_engine

    def _render_hybrid(self, eng, flat, loader, fillval, dtype_out, wts,
                       sc, emit_mips, mip_blur, crop_kwargs, kwargs):
        """Work-stealing host+device render of the flat block list: the
        device lane claims blocks from the front of the queue, host lane
        threads claim from the back and run the host path; whichever lane
        is faster ends up doing more blocks. Over a slow link with a
        blockwise source every block goes to the host lane."""
        from feabas_tpu import config as fconfig
        from feabas_tpu_torch.ops import link_probe
        n = len(flat)
        results = [None] * n
        host_kwargs = dict(kwargs)
        host_kwargs['return_empty'] = True
        for k in ('emit_mips', 'mip_blur', 'group_cap'):
            host_kwargs.pop(k, None)

        def host_block(i):
            blk = self.crop(flat[i], image_loader=loader,
                            device_render=False, **host_kwargs)
            if blk is not None and emit_mips:
                blk = _host_mip_tuple(blk, emit_mips, mip_blur)
            results[i] = blk

        if (not eng.source_can_reside(loader)
                and link_probe.is_slow_link(
                    link_probe.link_profile(device=self.device))):
            for i in range(n):
                host_block(i)
            return results
        state = {'lo': 0, 'hi': n}
        lock = threading.Lock()

        def claim_front():
            with lock:
                if state['lo'] >= state['hi']:
                    return None
                state['lo'] += 1
                return state['lo'] - 1

        def claim_back():
            with lock:
                if state['lo'] >= state['hi']:
                    return None
                state['hi'] -= 1
                return state['hi']

        def host_worker():
            while True:
                i = claim_back()
                if i is None:
                    return
                host_block(i)

        threads = [threading.Thread(target=host_worker, daemon=True)
                   for _ in range(fconfig.render_host_lanes())]
        for t in threads:
            t.start()
        try:
            dev_out = eng.render_blocks(
                flat, loader, float(fillval), dtype_out, wts=wts,
                shortcircuit=sc, emit_mips=emit_mips, mip_blur=mip_blur,
                group_cap=kwargs.get('group_cap'), claim=claim_front,
                **crop_kwargs)
        finally:
            for t in threads:
                t.join()
        for i, v in enumerate(dev_out):
            if v is not None:
                results[i] = (_complete_mip_tuple(v, emit_mips, mip_blur)
                              if emit_mips else v)
        return results


def render_whole_mesh(mesh, image_loader, prefix, **kwargs):
    """Render the full extent of a deformed mesh to output tiles
    (``feabas_tpu.renderer.render_whole_mesh`` through the port's
    renderer). Device rendering stays in this process and renders tile
    waves; the host path may fan tile batches out to workers.

    Kwargs: tile_size (h, w), pattern ({ROW_IND}/{COL_IND}), one_based,
    canvas_bbox, num_workers, tiles_per_job, mip_dirs, mip_blur, scale,
    device, and the crop kwargs. Returns {filename: bbox}.
    """
    tile_size = kwargs.pop('tile_size', (4096, 4096))
    pattern = kwargs.pop('pattern', '_tr{ROW_IND}-tc{COL_IND}.png')
    one_based = kwargs.pop('one_based', True)
    canvas_bbox = kwargs.pop('canvas_bbox', None)
    num_workers = int(kwargs.pop('num_workers', 1) or 1)
    tiles_per_job = int(kwargs.pop('tiles_per_job', 16))
    # render->mip fusion: each tile also emits len(mip_dirs) 2x levels
    mip_dirs = kwargs.pop('mip_dirs', None) or []
    mip_blur = float(kwargs.pop('mip_blur', 0.75) or 0.0)
    emit_mips = len(mip_dirs)
    scale = float(kwargs.pop('scale', 1.0))
    dev = device_mod.get_device(kwargs.pop('device', None))
    if scale != 1.0:
        mesh = mesh.copy()
        for g in (const.MESH_GEAR_FIXED, const.MESH_GEAR_MOVING):
            if mesh.vertices_initialized(g):
                mesh.set_vertices(mesh.vertices(g) * scale, g,
                                  offset=mesh.offset(g) * scale)
        if canvas_bbox is not None:
            canvas_bbox = tuple(v * scale for v in canvas_bbox)
    renderer = MeshRenderer.from_mesh(mesh, image_loader=image_loader,
                                      device=dev)
    if canvas_bbox is None:
        canvas_bbox = renderer.bounds
    x0 = int(np.floor(canvas_bbox[0]))
    y0 = int(np.floor(canvas_bbox[1]))
    x1 = int(np.ceil(canvas_bbox[2]))
    y1 = int(np.ceil(canvas_bbox[3]))
    ht, wd = tile_size
    cols = int(np.ceil((x1 - x0) / wd))
    rows = int(np.ceil((y1 - y0) / ht))
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols))
    rc = np.stack([rr.ravel(), cc.ravel()], -1)
    offset = 1 if one_based else 0
    jobs = []
    for r, c in rc[z_order(rc)]:
        bbox = (x0 + c * wd, y0 + r * ht, x0 + (c + 1) * wd, y0 + (r + 1) * ht)
        fname = prefix + pattern.format(ROW_IND=r + offset, COL_IND=c + offset)
        jobs.append((fname, bbox))
    mode = resolve_device_render(kwargs.get('device_render', None), dev)
    out = {}

    def emit(fname, bbox, blk):
        """Write mip0 (+ fused mip levels when requested)."""
        if emit_mips:
            mips = (blk if isinstance(blk, tuple)
                    else _host_mip_tuple(blk, emit_mips, mip_blur))
            common.imwrite(fname, mips[0])
            base = storage.base_name(fname)
            for lvl, d in enumerate(mip_dirs, start=1):
                common.imwrite(storage.join_paths(str(d), base), mips[lvl])
        else:
            common.imwrite(fname, blk)
        out[fname] = bbox

    loader_spec = None
    if num_workers > 1 and len(jobs) > 1 and not mode:
        try:
            loader_spec = image_loader.to_dict()
        except Exception:
            loader_spec = None      # not serializable: render here
    if loader_spec is not None:
        from feabas_tpu.concurrent import submit_to_workers
        batches = [jobs[i:i + tiles_per_job]
                   for i in range(0, len(jobs), tiles_per_job)]
        wk = dict(kwargs, mip_dirs=mip_dirs, mip_blur=mip_blur)
        args = [(mesh.get_init_dict(), loader_spec, batch, wk)
                for batch in batches]
        for rendered in submit_to_workers(subprocess_render_mesh_tiles,
                                          args, num_workers=num_workers):
            out.update(rendered)
        _write_mip_metadata(out, mip_dirs, image_loader)
        return out
    if mode:
        kwargs['device_render'] = mode      # resolved: don't re-consult config
        if emit_mips:
            kwargs['emit_mips'] = emit_mips
            kwargs['mip_blur'] = mip_blur
        wave = max(int(tiles_per_job), 1)
        for i0 in range(0, len(jobs), wave):
            grp = jobs[i0:i0 + wave]
            blks = renderer.crop_multiple([b for _, b in grp],
                                          return_empty=True, **kwargs)
            for (fname, bbox), blk in zip(grp, blks):
                if blk is not None:
                    emit(fname, bbox, blk)
        _write_mip_metadata(out, mip_dirs, image_loader)
        return out
    for fname, bbox in jobs:
        blk = renderer.crop(bbox, return_empty=True, **kwargs)
        if blk is not None:
            emit(fname, bbox, blk)
    _write_mip_metadata(out, mip_dirs, image_loader)
    return out


def subprocess_render_mesh_tiles(mesh_init, loader_spec, jobs, kwargs):
    """Worker: render a batch of output tiles of one section mesh on the
    host path (render_whole_mesh fans out only when it resolved to the
    host). Submeshes to the batch's bbox union; returns {filename: bbox}
    of the non-empty tiles."""
    from feabas_tpu.mesh import Mesh
    from feabas_tpu.dal import get_loader_from_json
    mesh_init = dict(mesh_init)
    mesh = Mesh(mesh_init.pop('vertices'), mesh_init.pop('triangles'),
                **mesh_init)
    boxes = np.asarray([b for _, b in jobs], np.float64).reshape(-1, 4)
    union = (boxes[:, 0].min(), boxes[:, 1].min(),
             boxes[:, 2].max(), boxes[:, 3].max())
    tb = mesh.triangle_bboxes(const.MESH_GEAR_MOVING)
    sel = ((tb[:, 0] < union[2]) & (tb[:, 2] > union[0]) &
           (tb[:, 1] < union[3]) & (tb[:, 3] > union[1]))
    if sel.any() and not sel.all():
        mesh = mesh.submesh(sel)
    renderer = MeshRenderer.from_mesh(
        mesh, image_loader=get_loader_from_json(loader_spec), device='cpu')
    kwargs = dict(kwargs, device_render=False)
    mip_dirs = kwargs.pop('mip_dirs', None) or []
    mip_blur = float(kwargs.pop('mip_blur', 0.75) or 0.0)
    out = {}
    for fname, bbox in jobs:
        blk = renderer.crop(bbox, return_empty=True, **kwargs)
        if blk is None:
            continue
        common.imwrite(fname, blk)
        if mip_dirs:
            mips = _host_mip_tuple(blk, len(mip_dirs), mip_blur)
            base = storage.base_name(fname)
            for lvl, d in enumerate(mip_dirs, start=1):
                common.imwrite(storage.join_paths(str(d), base), mips[lvl])
        out[fname] = bbox
    return out
