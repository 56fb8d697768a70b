"""Device selection, numerics flags and kernel launch counters.

The port computes on one torch device: ``get_device`` takes a name
(``'cuda'``, ``'cuda:1'`` or ``'cpu'``), or reads ``FEABAS_TORCH_DEVICE``
when given none, and is the CUDA card when neither names one. Asking for
CUDA where there is none raises: the CPU runs only when asked for by name.

Importing this module turns TF32 off for matmuls and cuDNN convolutions:
the DFT upsampler and the block affines need full f32 (the JAX package
runs them at ``Precision.HIGHEST`` for the same reason).

Every hand-written kernel's wrapper adds one to its counter here where it
launches the kernel, and nowhere else, so a run can show which kernels
its main path went through.
"""

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEVICE_ENV = 'FEABAS_TORCH_DEVICE'

_LAUNCHES = {'dog_filter': 0, 'gaussian_blur': 0, 'mesh_raster': 0,
             'peak_detect': 0, 'lradon_patch': 0, 'lradon_match': 0,
             'montage_blend': 0, 'fem_operator': 0}
# the same launches, by the shape the wrapper gave its kernel
_BY_SHAPE = {k: {} for k in _LAUNCHES}


def get_device(name=None):
    """Resolve a device name (default: ``FEABAS_TORCH_DEVICE``, else
    ``'cuda'``) to a ``torch.device``; raises when CUDA is asked for and
    absent."""
    if isinstance(name, torch.device):
        name = str(name)
    if name is None:
        name = os.environ.get(DEVICE_ENV) or 'cuda'
    dev = torch.device(str(name).strip().lower())
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {name!r} requested but CUDA is not '
                           'available')
    return dev


def launch_on(index, fn, *args):
    """``fn(*args, stream)``, a kernel's C launcher, with CUDA device
    ``index`` current and the raw handle of its current stream last;
    returns the launcher's CUDA error code."""
    get = getattr(torch._C, '_cuda_getCurrentRawStream', None)

    def stream():
        return get(index) if get is not None \
            else torch.cuda.current_stream(index).cuda_stream
    if torch.cuda.current_device() == index:
        return fn(*args, stream())
    with torch.cuda.device(index):
        return fn(*args, stream())


def count_launch(kernel, shape=None):
    _LAUNCHES[kernel] += 1
    key = 'x'.join(str(int(d)) for d in shape) if shape is not None else '?'
    _BY_SHAPE[kernel][key] = _BY_SHAPE[kernel].get(key, 0) + 1


def reset_launch_counts():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
        _BY_SHAPE[k].clear()


def launch_counts():
    return dict(_LAUNCHES)


def launch_counts_by_shape():
    """{kernel: {'NxHxW': launches}} since the last reset."""
    return {k: dict(v) for k, v in _BY_SHAPE.items()}
