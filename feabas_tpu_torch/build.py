"""Build and load the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, under ``feabas_tpu_torch/_build/``
(git-ignored), named by a hash of the source so an edited kernel always
rebuilds. The library loads with ``ctypes``, its C functions declared by
``bind``. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')


def _nvcc():
    path = shutil.which('nvcc')
    if path is None:
        home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
        cand = os.path.join(home, 'bin', 'nvcc')
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError('nvcc not found: the CUDA kernels build only on '
                           'a host with the CUDA toolkit')
    return path


def library_path(name):
    src = os.path.join(SRC_DIR, name + '.cu')
    with open(src, 'rb') as f:
        digest = hashlib.sha1(f.read() + ' '.join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f'lib{name}-{digest.hexdigest()[:12]}.so')


def build(name):
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path."""
    src, lib = library_path(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, src]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {src}:\n{proc.stderr}')
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load(name):
    """Build (if needed) and ``ctypes``-load ``csrc/<name>.cu``."""
    return ctypes.CDLL(build(name))


def bind(name, signatures):
    """``load`` ``csrc/<name>.cu`` and declare its C functions:
    ``signatures`` maps each function's name to its ``ctypes`` argument
    types; every one returns an int (a CUDA error code, or a constant of
    the source)."""
    lib = load(name)
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib
