"""Host<->device link profile for adaptive routing (counterpart of
``feabas_tpu/ops/link_probe.py``).

The first caller pays a short probe of the torch device: the latency of a
tiny blocking round trip on the host clock, and the 4 MB download and
upload rates timed with CUDA events around the copies. Routers (render
group size, the hybrid render lane) read the cached numbers.
``is_slow_link`` keeps the JAX package's threshold.
"""

import threading
import time

import numpy as np
import torch

from feabas_tpu_torch import device as device_mod

_LOCK = threading.Lock()
_PROFILE = None
_MB = 4.194304          # one 2048 x 2048 uint8 buffer, in MB


def _copy_mbps(fn):
    """MB/s of the 4 MB copy ``fn`` timed with CUDA events (after one
    warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return _MB / max(start.elapsed_time(stop) * 1e-3, 1e-9)


def _measure(dev):
    if dev.type != 'cuda':
        # host tensors ARE device tensors: a null-cost link
        return {'platform': dev.type, 'latency_s': 0.0,
                'down_MBps': float('inf'), 'up_MBps': float('inf')}
    small = torch.zeros(1024, dtype=torch.uint8)
    small.to(dev).cpu()                        # warm-up (context, allocator)
    lats = []
    for _ in range(5):
        t0 = time.perf_counter()
        small.to(dev).cpu()
        lats.append(time.perf_counter() - t0)
    host = torch.zeros((2048, 2048), dtype=torch.uint8).pin_memory()
    buf = torch.zeros((2048, 2048), dtype=torch.uint8, device=dev)
    down = _copy_mbps(lambda: host.copy_(buf, non_blocking=True))
    up = _copy_mbps(lambda: buf.copy_(host, non_blocking=True))
    return {'platform': 'cuda', 'latency_s': float(np.median(lats)),
            'down_MBps': float(down), 'up_MBps': float(up)}


def link_profile(device=None):
    """Measured link profile dict (platform, latency_s, down_MBps,
    up_MBps), cached per process; thread-safe."""
    global _PROFILE
    with _LOCK:
        if _PROFILE is None:
            _PROFILE = _measure(device_mod.get_device(device))
        return dict(_PROFILE)


def is_slow_link(profile=None):
    """True when per-transfer latency dominates small transfers: latency
    above ~5 ms means a 4 MB fetch pays >= 5% overhead per round trip."""
    p = profile or link_profile()
    return p['latency_s'] > 5e-3


def set_profile_for_testing(profile):
    """Test hook: inject a fake profile (or None to re-measure)."""
    global _PROFILE
    with _LOCK:
        _PROFILE = profile
