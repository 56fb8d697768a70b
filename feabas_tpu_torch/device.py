"""Device selection, numerics flags and kernel launch counters.

The port computes on one torch device, chosen explicitly: ``get_device``
takes a name (``'cuda'``, ``'cuda:1'``, ``'cpu'`` or ``'auto'``), or reads
``FEABAS_TORCH_DEVICE`` when given none. Asking for CUDA where there is
none raises; only ``'auto'`` resolves to the CPU when no card is present.

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

_LAUNCHES = {'dog_filter': 0, 'gaussian_blur': 0, 'mesh_raster': 0}


def get_device(name=None):
    """Resolve a device name to a ``torch.device``; raises when CUDA is
    asked for and absent."""
    if isinstance(name, torch.device):
        name = str(name)
    if name is None:
        name = os.environ.get(DEVICE_ENV, 'auto')
    name = str(name).strip().lower()
    if name == 'auto':
        return torch.device('cuda' if torch.cuda.is_available() else 'cpu')
    dev = torch.device(name)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {name!r} requested but CUDA is not '
                           'available')
    return dev


def count_launch(kernel):
    _LAUNCHES[kernel] += 1


def reset_launch_counts():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def launch_counts():
    return dict(_LAUNCHES)
