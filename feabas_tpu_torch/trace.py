"""Spans and counters of the port's host work.

``span(name)`` is a profiler range named ``feabas.<name>`` around a piece
of host work: with no profiler attached it costs about a microsecond;
under ``torch.profiler`` (a benchmark's traced run, or an operator's own
session) it lands on the profiler's clock beside the device's events, so
an idle stretch of the card can be put down to the span the host was in.
The range is a function-scope record, not a user annotation: a user
annotation also gets a copy on the device's timeline, which a reader of
the device events would count as device work. A span never synchronizes.

``count(name, n)`` adds a host integer to a counter; ``counters()`` reads
them all and ``reset_counters()`` zeroes them. A counter is given what the
host already holds (a loop's trips, an image's shape), never a device
tensor, so counting adds no device work and no sync. The hand-written
kernels' launches are counters too (``launch.<kernel>``, and by the shape
the wrapper gave the kernel), read through ``device.launch_counts``.

Spans and counters in the port:

- ``loader.decode`` (span), ``loader.decodes``, ``loader.decoded_px``:
  each image file decoded (``common.imread``);
- ``loader.meta_headers``, ``loader.meta_decodes``: an image file's dtype,
  channels and size read from its header (``common.image_meta``), or
  from a whole decode where the header does not settle them
  (``dal._file_meta``: the loaders' first-tile probe);
- ``loader.decode_batch`` (span), ``loader.decode_batches``,
  ``loader.batched_decodes``: a crop whose uncached tiles decoded on the
  decode pool, from the first submit to the last paste on the calling
  thread, and the decodes it issued there (``dal.StaticImageLoader.crop``);
- ``loader.resize``: the align loader's area downscale to the working mip;
- ``loader.cache_lookups``, ``loader.cache_hits``: the image loaders'
  cache gets (whole images and border bands);
- ``blender.encode`` (span), ``blender.encodes``: each image file
  encoded and written (``common.imwrite``);
- ``render.encode_batch`` (span), ``render.encode_batches``,
  ``render.batched_encodes``: a list of files written side by side on
  the decode pool (``common.imwrite_many``, the mesh renderer's card
  route writes a wave's tiles so), on the calling thread from the
  first submit to the last write's end, and the files it wrote, the
  calling thread's own included;
- ``matcher.seed``: the align matcher's global translation seed;
- ``io.h5``: mesh, match and stitcher H5 reads and writes;
- ``solver.cg_calls``, ``solver.cg_iters``: each CG solve and the loop
  trips it ran;
- ``thumbnail.features``, ``thumbnail.feature_match``, ``thumbnail.ransac``,
  ``thumbnail.subpixel``, ``thumbnail.verify``, ``thumbnail.refine``
  (spans), ``thumbnail.keypoints``, ``thumbnail.match_rounds``,
  ``thumbnail.ransac_calls``, ``thumbnail.ransac_trials``,
  ``thumbnail.coarse_matches``, ``thumbnail.refined_matches``: the
  thumbnail matcher's stages and what they kept (``thumbnail.py``);
- ``render.raster``, ``render.tables`` (spans), ``render.blocks``,
  ``render.device_blocks``, ``render.lanczos_px``: the mesh renderer's
  raster of a crop wave, on the card route from the engine's first
  dispatch to its last fetch, on the host route ``render_by_subregions``;
  the engine's candidate and table build; the blocks rendered, those
  rendered on a CUDA card, and the output px sampled by Lanczos-4
  (``renderer.py``, ``ops/render.DeviceRenderEngine``);
- ``volume.chunk`` (span): one xy chunk of a volume slab, its layers'
  crops, the stack and the write (``renderer._render_one_slab_chunk``);
  ``volume.write`` (span): the volume writer's transpose and store write
  (``dal.TensorStoreWriter``); ``volume.chunk_writes``,
  ``volume.partial_writes``: the writer's store writes, and those that
  cover part of a storage chunk's extent (the store read-modify-writes
  that chunk); ``volume.layers``, ``volume.layer_px``: the section layers
  rendered into written chunks and their H x W; ``volume.empty_layers``:
  layers of a written slab chunk that no block covered, left at the
  store's fill (``renderer.py``);
- ``<cli>.<mode>`` and ``<cli>.<mode>.<unit>``: the CLI drivers' stages
  and their per-section or per-pair work (``logging.stage_timer``);
- ``launch``: each kernel launch made through ``device.launch_on``.

A span is an operator range to the profiler, so a kernel launched from C
(with no operator of its own) is linked to the innermost span open around
it: ``launch`` keeps that span at the launch itself.
"""

import functools
import threading

import torch

PREFIX = 'feabas.'

# a function-scope range (``record_function`` opens a user annotation)
_Range = torch._C._profiler._RecordFunctionFast

_LOCK = threading.Lock()
_COUNTS = {}
# {kernel: {'NxHxW': launches}}
_BY_SHAPE = {}


def span(name):
    """Context manager: the profiler range ``feabas.<name>``."""
    return _Range(PREFIX + name)


def spanned(name):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name, n=1):
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def count_launch(kernel, shape=None):
    key = 'x'.join(str(int(d)) for d in shape) if shape is not None else '?'
    with _LOCK:
        name = 'launch.' + kernel
        _COUNTS[name] = _COUNTS.get(name, 0) + 1
        by = _BY_SHAPE.setdefault(kernel, {})
        by[key] = by.get(key, 0) + 1


def counters():
    """{name: count} since the last reset (a copy)."""
    with _LOCK:
        return dict(_COUNTS)


def launches_by_shape():
    """{kernel: {'NxHxW': launches}} since the last reset (a copy)."""
    with _LOCK:
        return {k: dict(v) for k, v in _BY_SHAPE.items()}


def reset_counters():
    """Zero every counter, the launch counters too."""
    with _LOCK:
        _COUNTS.clear()
        _BY_SHAPE.clear()
