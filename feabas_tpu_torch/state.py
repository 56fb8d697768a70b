"""The JAX package's host-side state, carried into the port and onto a
torch device.

The system has no weights. What its device programs take are host numpy
trees: the fused-match prep dict and its per-round tables
(``matcher._fused_prep``), the SLM system arrays (``optimizer``), the
montage tables (``ops.montage_render``), the stacked window system
(``parallel.window.build_stack_system`` / ``slm_window_to_stack``) and the
render tables and cell candidates (``ops.render.DeviceRenderEngine``).
``to_tensors`` turns any such tree into tensors on one device;
``cast_floats`` pins the float width first, so a test can hand the JAX
package and the port the same inputs. ``mesh_from_init_dict`` and
``match_from_arrays`` rebuild a JAX ``Mesh`` or ``Match`` as the port's
from their plain numpy arrays and strings, and ``keypoints_from_arrays`` a
thumbnail ``KeyPoints``, so port code receives only the port's objects.
"""

import threading

import numpy as np
import torch

# prep keys that hold per-pair arrays (matcher._fused_prep)
FUSED_ARRAY_KEYS = ('src0', 'src1', 'pos1', 'verts0_1', 'shape1', 'tris1',
                    'mult', 'poisson', 'shape0', 'tris0', 'mult0',
                    'poisson0', 'pos0')


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return fn(np.asarray(tree))
    return tree


def cast_floats(tree, dtype=np.float32):
    """Cast every floating numpy array (or scalar) of a tree to ``dtype``."""
    return _map(tree, lambda a: a.astype(dtype)
                if np.issubdtype(a.dtype, np.floating) else a)


def to_tensors(tree, device, float_dtype=torch.float32):
    """Numpy tree -> tensors on ``device``: floats become ``float_dtype``,
    signed integers int64 (index arrays), other dtypes (uint8 images,
    bools) keep theirs. Non-array leaves pass through."""
    def conv(a):
        if np.issubdtype(a.dtype, np.floating):
            return torch.as_tensor(a, dtype=float_dtype, device=device)
        if np.issubdtype(a.dtype, np.signedinteger):
            return torch.as_tensor(a.astype(np.int64), device=device)
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return _map(tree, conv)


def stack_preps(preps):
    """Stack same-signature fused preps into the pair-axis numpy tree that
    ``ops.match_loop.fused_rounds_batched`` takes (before ``to_tensors``):
    {key: (P, ...)} for FUSED_ARRAY_KEYS, 'rounds' (tuple of dicts of
    (P, ...)) and 'coarse' (dict of (P, ...) or None)."""
    p0 = preps[0]

    def stack(vals):
        return np.stack([np.asarray(v) for v in vals])

    out = {k: stack([p[k] for p in preps]) for k in FUSED_ARRAY_KEYS}
    out['rounds'] = tuple(
        {k: stack([p['rounds'][r][k] for p in preps]) for k in p0['rounds'][r]}
        for r in range(len(p0['rounds'])))
    out['coarse'] = ({k: stack([p['coarse'][k] for p in preps])
                      for k in p0['coarse']}
                     if p0['coarse'] is not None else None)
    return out


# window-system keys stack_solve takes (the rest is host bookkeeping)
WINDOW_KEYS = ('verts0', 'u', 'tris', 'multiplier', 'poisson', 'links',
               'r_rest', 'free', 'linc', 'sten')


def window_system_to_device(system, device, float_dtype=torch.float32):
    """The solve arrays of a stacked window system (including the optional
    ``linc`` link transpose and ``sten`` stencil assembly table) as
    tensors on ``device``; host-only keys stay behind."""
    return to_tensors({k: system[k] for k in WINDOW_KEYS
                       if system.get(k) is not None}, device, float_dtype)


_TORCH_DTYPES = {'uint8': torch.uint8, 'float32': torch.float32,
                 'int32': torch.int32}


class _PinnedStage:
    """One growing page-locked host buffer per CUDA device, reused by every
    batch: arrays are written into it and leave as asynchronous copies on
    the current stream. The next batch waits for those copies (an event)
    before it overwrites the buffer."""

    def __init__(self):
        self.buf = None
        self.done = None

    def upload(self, parts, device):
        """parts: [(list of same-shape arrays to stack | array, dtype)] ->
        one device tensor each, same bytes as a synchronous copy."""
        specs, total = [], 0
        for arrs, dt in parts:
            stacked = isinstance(arrs, (list, tuple))
            shape = ((len(arrs),) + arrs[0].shape) if stacked else arrs.shape
            nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
            specs.append((arrs, np.dtype(dt), stacked, shape, total, nbytes))
            total += -(-nbytes // 256) * 256
        if self.done is not None:
            self.done.synchronize()
        if self.buf is None or self.buf.numel() < total:
            self.buf = torch.empty(max(total, 1), dtype=torch.uint8,
                                   pin_memory=True)
        out = []
        for arrs, dt, stacked, shape, off, nbytes in specs:
            held = self.buf[off:off + nbytes].view(_TORCH_DTYPES[dt.name])
            held = held.view(shape)
            view = held.numpy()
            if stacked:
                for k, a in enumerate(arrs):
                    view[k] = a
            else:
                view[...] = arrs
            out.append(torch.empty_like(held, device=device)
                       .copy_(held, non_blocking=True))
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(device))
        return out


# one stage per thread and device: concurrent renderers share no buffer
_STAGES = threading.local()


def render_batch_to_device(src, tables, cands, device):
    """One raster batch on ``device``: the source (one array, or a list of
    same-shape crops to stack; uint8 or float32 as given, other dtypes
    widened to float32; None passes through), the (B, Tp, 14) float32
    tables and the (B, NC, K) int32 cell candidates (or None), as
    ``ops.render.raster_blocks`` takes them. On a CUDA device the arrays
    are staged through one reused page-locked buffer and copied
    asynchronously on the current stream."""
    stacked = isinstance(src, (list, tuple))
    if device.type != 'cuda':
        if src is not None:
            src = np.stack(src) if stacked else np.ascontiguousarray(src)
            if src.dtype not in (np.uint8, np.float32):
                src = src.astype(np.float32)
            src = torch.from_numpy(src).to(device)
        return (src,
                torch.from_numpy(np.asarray(tables, np.float32)).to(device),
                None if cands is None
                else torch.from_numpy(np.asarray(cands, np.int32)).to(device))
    parts = [(np.asarray(tables), np.float32)]
    if cands is not None:
        parts.append((np.asarray(cands), np.int32))
    if src is not None:
        dt = (src[0] if stacked else src).dtype
        parts.append((src, dt if dt in (np.uint8, np.float32)
                      else np.float32))
    stages = _STAGES.__dict__.setdefault('by_device', {})
    out = stages.setdefault(str(device), _PinnedStage()).upload(parts, device)
    return (out[-1] if src is not None else None, out[0],
            out[1] if cands is not None else None)


def mesh_from_init_dict(init):
    """The port's ``Mesh`` from a ``Mesh.get_init_dict()`` of either
    package: numpy arrays, scalars and the material table as JSON. The
    arrays are copied, so the two meshes share no state."""
    from feabas_tpu_torch.mesh import Mesh
    kw = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
          for k, v in init.items()}
    return Mesh(kw.pop('vertices'), kw.pop('triangles'), **kw)


def match_from_arrays(xy0, xy1, weight, strain=None):
    """The port's ``common.Match`` from a match's arrays (a JAX ``Match``
    unpacks into them: ``match_from_arrays(*match)``)."""
    from feabas_tpu_torch.common import Match
    xy0, xy1, weight = (np.array(a) for a in (xy0, xy1, weight))
    if strain is None:
        return Match(xy0, xy1, weight)
    return Match(xy0, xy1, weight, strain)


def keypoints_from_arrays(xy, response=None, class_id=None, des=None):
    """The port's ``thumbnail.KeyPoints`` from a keypoint set's host arrays
    (a JAX ``KeyPoints`` hands over ``kp.xy, kp.response, kp.class_id,
    kp.des``). The arrays are copied; the device-resident descriptors are
    not carried."""
    from feabas_tpu_torch.thumbnail import KeyPoints
    kp = KeyPoints(np.array(xy),
                   None if response is None else np.array(response),
                   None if class_id is None else np.array(class_id))
    if des is not None:
        kp.des = np.array(des, dtype=np.float32)
    return kp
