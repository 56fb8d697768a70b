"""In-memory caches with item-count and byte-size eviction.

Covers the reference's cache families (``feabas/caching.py``: FIFO/LRU/
LFU/MFU + a null cache) with one ordered-dict implementation per policy.
Byte accounting uses numpy ``nbytes`` where available so image-tile caches
can be capped in MiB.

The port's copy of ``feabas_tpu/caching.py``, cut to what the port reaches.
"""

import threading
from collections import OrderedDict

import numpy as np


def _sizeof(val):
    if isinstance(val, np.ndarray):
        return val.nbytes
    if isinstance(val, (tuple, list)):
        return sum(_sizeof(v) for v in val)
    if isinstance(val, dict):
        return sum(_sizeof(v) for v in val.values())
    if isinstance(val, (bytes, bytearray, str)):
        return len(val)
    return 64  # nominal for scalars / small objects


class CacheNull:
    """No-op cache: the shared API, caches nothing."""

    def __init__(self, maxlen=None, maxbytes=None):
        self._maxlen = maxlen
        self._maxbytes = maxbytes

    def __contains__(self, key):
        return False

    def __len__(self):
        return 0

    def get(self, key, default=None):
        return default

    def __getitem__(self, key):
        raise KeyError(key)

    def __setitem__(self, key, value):
        pass

    def update_item(self, key, value):
        self[key] = value

    def clear(self, instant_gc=False):
        pass

    def pop(self, key, default=None):
        return default

    def trim(self):
        pass


class _CacheBase(CacheNull):
    def __init__(self, maxlen=None, maxbytes=None):
        super().__init__(maxlen, maxbytes)
        self._store = OrderedDict()
        self._bytes = 0
        # caches are shared by thread consumers (loader block caches under
        # the threaded mip/render fan-outs); an RLock keeps the eviction
        # bookkeeping consistent. Re-created after pickling (locks don't
        # pickle; worker processes get their own).
        self._lock = threading.RLock()

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop('_lock', None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.RLock()

    def __contains__(self, key):
        return key in self._store

    def __len__(self):
        return len(self._store)

    def _evict_one(self):
        raise NotImplementedError

    def trim(self):
        with self._lock:
            while self._store and (
                (self._maxlen is not None and len(self._store) > self._maxlen)
                or (self._maxbytes is not None and self._bytes > self._maxbytes)
            ):
                self._evict_one()

    def _pop(self, key):
        val, nb = self._store.pop(key)
        self._bytes -= nb
        return val

    def pop(self, key, default=None):
        """Remove and return a cached item (cache-invalidation hook for
        externally modified artifacts, e.g. tforms rewritten by a remote
        worker)."""
        with self._lock:
            if key in self._store:
                return self._pop(key)
            return default

    def __setitem__(self, key, value):
        with self._lock:
            if key in self._store:
                self._pop(key)
            nb = _sizeof(value)
            self._store[key] = (value, nb)
            self._bytes += nb
            self.trim()

    update_item = __setitem__

    def get(self, key, default=None):
        with self._lock:
            if key in self._store:
                return self[key]
            return default

    def clear(self, instant_gc=False):
        with self._lock:
            self._store.clear()
            self._bytes = 0
        if instant_gc:
            import gc
            gc.collect()


class CacheFIFO(_CacheBase):
    def __getitem__(self, key):
        return self._store[key][0]

    def _evict_one(self):
        key = next(iter(self._store))
        self._pop(key)


class CacheLRU(_CacheBase):
    def __getitem__(self, key):
        with self._lock:
            self._store.move_to_end(key)
            return self._store[key][0]

    def _evict_one(self):
        key = next(iter(self._store))
        self._pop(key)


class _FreqCache(_CacheBase):
    """Shared machinery for LFU / MFU."""

    def __init__(self, maxlen=None, maxbytes=None):
        super().__init__(maxlen, maxbytes)
        self._freq = {}

    def __getitem__(self, key):
        with self._lock:
            self._freq[key] = self._freq.get(key, 0) + 1
            return self._store[key][0]

    def __setitem__(self, key, value):
        self._freq.setdefault(key, 0)
        super().__setitem__(key, value)

    update_item = __setitem__

    def _pop(self, key):
        self._freq.pop(key, None)
        return super()._pop(key)

    def clear(self, instant_gc=False):
        self._freq.clear()
        super().clear(instant_gc)


class CacheLFU(_FreqCache):
    def _evict_one(self):
        key = min(self._store, key=lambda k: self._freq.get(k, 0))
        self._pop(key)


class CacheMFU(_FreqCache):
    """Evict the most-used entry first — suits render-once sweeps where a
    tile already consumed by all neighbors will not be needed again."""

    def _evict_one(self):
        key = max(self._store, key=lambda k: self._freq.get(k, 0))
        self._pop(key)


_POLICIES = {
    'none': CacheNull, 'null': CacheNull,
    'fifo': CacheFIFO, 'lru': CacheLRU, 'lfu': CacheLFU, 'mfu': CacheMFU,
}


def generate_cache(cache_type='fifo', maxlen=None, maxbytes=None):
    """Factory. ``maxbytes`` may be given in MiB via float('...MB') callers;
    here it is plain bytes."""
    if cache_type is None:
        cache_type = 'none'
    cls = _POLICIES[str(cache_type).lower()]
    if cls is CacheNull or (maxlen is None and maxbytes is None):
        # unbounded caches are a leak hazard; cap item count defensively
        if cls is not CacheNull and maxlen is None and maxbytes is None:
            maxlen = 4096
    return cls(maxlen=maxlen, maxbytes=maxbytes)
