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
its main path went through. The counters live in ``trace`` (as
``launch.<kernel>``); the functions here are views of them.
"""

import os

import torch

from feabas_tpu_torch import trace

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEVICE_ENV = 'FEABAS_TORCH_DEVICE'

KERNELS = ('dog_filter', 'gaussian_blur', 'mesh_raster', 'peak_detect',
           'lradon_patch', 'lradon_match', 'montage_blend', 'fem_operator',
           'subpixel_refine', 'mesh_raster_lanczos4')


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
    returns the launcher's CUDA error code. The launch runs inside the
    span ``launch``: a profiler links a launch made from C to the innermost
    range open around it, and this one starts inside the caller's own."""
    get = getattr(torch._C, '_cuda_getCurrentRawStream', None)

    def stream():
        return get(index) if get is not None \
            else torch.cuda.current_stream(index).cuda_stream
    with trace.span('launch'):
        if torch.cuda.current_device() == index:
            return fn(*args, stream())
        with torch.cuda.device(index):
            return fn(*args, stream())


def count_launch(kernel, shape=None):
    if kernel not in KERNELS:
        raise KeyError(kernel)
    trace.count_launch(kernel, shape)


def reset_launch_counts():
    """Zeroes every counter of ``trace``, the launch counters with them."""
    trace.reset_counters()


def launch_counts():
    c = trace.counters()
    return {k: c.get('launch.' + k, 0) for k in KERNELS}


def launch_counts_by_shape():
    """{kernel: {'NxHxW': launches}} since the last reset."""
    by = trace.launches_by_shape()
    return {k: by.get(k, {}) for k in KERNELS}
