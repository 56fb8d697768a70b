"""Chip smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the hand-written kernels from feabas_tpu_torch/csrc, one
     nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card, at every
     shape the four paths below launch it with (the montage blend's, in
     phase 4 on the blocks that path blends; the general CG operator's,
     in phase 7 on the systems that path solves), with both times from CUDA
     events and each kernel's bound (the larger of its FLOP over 67 TFLOP/s
     and its bytes over 3.35 TB/s) and share of it:
     the DoG (sigma 1.25, 2.5 and 3.5, whole planes and halo tiles) and
     blur (the pooled bands' mask term, the 4096^2 low band), each also
     beside a replicate-pad ``F.conv2d`` library call (and, at (128, 64,
     64) and (1, 2048, 2048) sigma 3.5 and the blur of (4, 4096, 4096),
     its device time per call from a CUDA-graph replay), the edges of
     both code paths of the DoG kernel (a 1x1 plane, 3x700, 24x24 at sigma
     3.5, 129x130 tiles, the mask term's largest radius), and the mesh
     raster, bit-equal with equal coverage flags, on the align path's
     batches (1 to 4 cell-binned 2048^2 blocks of a deformed section mesh,
     each with its own source crop), four 512^2 flat-table blocks on one
     resident source, a tie of two identical rows, which the first must
     win, and the edges of its design (see ``check_raster``), with its
     device time per launch and what its tile cull removes; then the
     batch upload, staged against pageable; then the montage blend,
     bit-equal with the expected covered flag, on the edges of its design
     (``montage_cases``: a 4096^2 LINEAR block, ragged blocks, empty
     cells, the identical-tile tie, a dense mesh, K = K_CAP, a tile at half
     size turned by 30 degrees, one cell, a cell count that is no multiple
     of the kernel's persistent grid), after its registers, spills and
     resident blocks a SM as the runtime reports them, with its
     device time per launch, rows kept per cell and samples per pixel;
     then the three kernels of the thumbnail path, each also beside one
     PyTorch library call of the same function (``check_lradon``): the peak response (bit-equal; 2048^2 at
     window 10 with and without a mask, a 1x1 and a 7x300 plane, windows
     1, 2, 3, 7, 31 and 32, plateaus, a 2049 x 2047 plane with a mask),
     the LRadon descriptors (<= 1e-5; 5000 keypoints on
     2048^2, keypoints on every border and corner with fractional offsets
     0 and just under 1, a 3000x2000 image, beam radii 30 and 45, 4 x 6
     bins) and the rotation-exhaustive match (indices, best rotation and
     mutual flags equal except where the plain version's top two are
     closer than 1e-5, which are counted; 5000 x 5000 x 12 variants,
     64 x 4096, one side masked, duplicated descriptors, no rotation
     search, pairs whose best variant is 0, in 1..P-1 and in P..2P-1,
     4 x 6 descriptors, 100 x 3001); each of these rows also with its
     device time per call from a CUDA-graph replay; then the general CG
     operator (``check_fem``) on a synthetic pair of cartesian meshes of
     1000 x 1000 vertices in all (2M DOF) with 1e5 links, at each of its
     lanes a vertex G (4, 8, 16, 32) within 1e-5 of max|y| of its plain
     version and bit-equal to itself, with its device time at each G, and
     at the G its tables chose beside one ``torch.sparse.mm`` of the
     assembled matrix, with the registers, spills and resident blocks a SM
     of that instantiation (the path systems in phases 4 to 7); then the
     subpixel refinement of the thumbnail matches (``check_subpixel``):
     the same kept set as its plain version and shifts within 1e-4 px, on
     a 4096^2 pair of a sigma-1.5 texture shifted by (17.3, -9.6) px with
     1,369 matches (the thumbnail cell's size), windows at every bound of
     the images and one match; the first timed beside its device time
     from a CUDA-graph replay and the host route it replaces (scipy DoGs,
     FFT correlation, numpy Lucas-Kanade steps) on the same pair;
  4. the stitch slice: a synthetic 2x3 grid of 3000x4000 uint8 tiles
     (10% overlap, 3 px stage jitter, made on the card from a seed) goes
     through ``feabas_tpu_torch.scripts.stitch_main`` matching,
     optimization and rendering; matches, placements and the render are
     checked against the ground truth, and the montage blend must launch
     at least once per output block; after the counts are read, each block
     the path blended is rebuilt from its work dir (``stitch_blocks``),
     must have the shapes launched, and is held bit-equal to the plain
     version and timed as in phase 3; the block at (1, 1) is blended once
     more after ``MontageRenderer.add_transfer_functions`` with a seeded
     LUT of non-identity lines (``seeded_lut``) and held bit-equal to the
     plain version, and ``generate_roi_mask`` at 1/16 must cover the union
     of the placed tile rectangles to within 1 px; the general CG operator
     (which the fused match schedule's per-round solve and the fused ENG
     solve of optimization now launch) is held against its plain version
     on a copy of each system the path bound it to, the most launched
     timed as in phase 3; the first per-round match solve and the first
     optimization solve run twice more on the inputs the path gave them;
  5. the align slice: 8 sections of 8192x8192 uint8 at 4 nm (a seeded
     texture moved by a cumulative N(0, 24 px) drift and a smooth warp,
     made on the card) go through ``feabas_tpu_torch.scripts.align_main``
     meshing, matching (working mip 2), optimization and rendering (at
     LINEAR), then rendering again at the shipped LANCZOS with
     ``device_render`` unset into a second out dir, which must launch the
     raster's Lanczos-4 mode; the matches are checked against the analytic
     truth, the window against the stacked solve, each render against
     section 0 and the LANCZOS render against the LINEAR one; the operator's
     systems are held as in phase 4; the first stacked window solve runs
     twice more on its inputs, and ``relax_mesh`` three times on a
     section's mesh carried through its tform (``relax_check``);
  6. the thumbnail slice: 6 sections of 8192x8192 uint8 at 4 nm, each a
     rigid motion of one seeded texture (turns of 0 or 30 degrees plus a
     draw within +-2 degrees, so that every pair is turned by about 0, +30
     or -30 degrees, which is what the feature stage resolves;
     translations N(0, 200 px)), go through
     ``feabas_tpu_torch.scripts.thumbnail_main`` downsample and alignment
     (matching, optimization, render) at thumbnail mip 2 (2048^2
     thumbnails) with the default feature settings; all 9 pairs must
     match, feature and refined matches are held against the analytic
     motion, each pair's best rotation variant against its relative
     angle, the aligned thumbnails against section 0;
  7. the nonlinear align slice: the first 4 sections of phase 5's stack,
     each with a material mask at mip 4 (512^2), sections 1 and 2 with a
     seeded band of the shipped nonlinear 'wrinkle' material (label 50,
     24 mask px wide), go through the align CLI as in phase 5; matches are
     checked against the analytic truth, the window must not take the
     stacked solve (Newton-Raphson does), the tforms must hold no flipped
     triangle, the render must overlay section 0, and the general CG
     operator must launch in matching and in optimization; after the
     counts are read, the operator is held against its plain version and
     timed, as in phase 3, on a copy of each system (NV, NT, L) the path
     bound it to, taken as the path bound it;
  8. chunked alignment (``run_chunked``, after phase 5 on a copy of its
     meshes and matches): the align CLI's optimization with
     chunked_to_depth 2 and chunks of 2 (4 chunks -> 4 metas -> 2 chunks ->
     2 metas -> a window); every tform written, every chunk committed, no
     flipped triangle, pair residues within the rule of
     tests/test_aligner.py against phase 5's windowed tforms; the same
     command again on that tform dir must make no window solve and keep
     every tform's bytes, and a run into a fresh copy must give the same
     tforms bit for bit;
  9. the volume output (``run_volume``, after phases 4 and 5 on copies of
     their work dirs, through the port's volume store: tensorstore where
     it is installed, else ``_tslite``, whose name it prints): (a) phase
     4's section through the stitch CLI's rendering with a
     neuroglancer_precomputed driver (raw 256^2 chunks), held against
     phase 4's PNG render (cc >= 0.99, median |diff| 0; the montage blend
     and the blur must launch); (b) phase 5's stack through ``align_main
     --mode tsr`` (LINEAR, device rendering, 2048^2 x 64 chunks), each
     layer within 1 LSB of phase 5's rendered section over the canvas, the
     mesh raster launched, and a second tsr writing no chunk; (c)
     ``--mode tsd`` (mips 1, 3, 5, 7, z 'auto'): 5 scales in the info, and
     chunks of each (a corner one among them) bit-equal to a numpy mean of
     the base (``block_reduce``); (d) the highpass mip-6 thumbnail of (a)'s
     volume against the max-minus-min construction over phase 4's PNG
     render, and the plain one against ``mipmap.create_thumbnail`` of it
     (cc > 0.9 each); with stage seconds, chunks and MB written and MB/s.
After the phases one ``[determinism]`` line lists each solve whose sums
once took CUDA atomics, run again in phase 4 or 5 on inputs its path gave
it, bit-equal to itself and to what the path got (a difference fails the
run).
Each slice resets the kernels' launch counts just before it and reads
them just after (in total and by shape), and fails if a kernel of its
path never launched. Then one JSON line lists each of the eleven kernels with
its launches (in all and by path), its worst error, and the times, bound
and library time of the checked shape the paths launched most, then all its
phase-3 checks; the line before
last is nvidia-smi's card line; the last line is one JSON object
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.

``--phases`` (a comma list of kernels, stitch, align, chunked, thumbnail,
nonlinear, volume; chunked needs align, volume stitch and align) runs a
part of it, for work on one path; the kernels line and the ok line are
printed only by the whole run. ``--profile`` wraps each stitch,
thumbnail and volume stage in one ``torch.profiler`` pass and prints its
device time by kernel.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
TILE_H, TILE_W = 3000, 4000
ROWS, COLS = 2, 3
OVERLAP_Y, OVERLAP_X = 300, 400       # 10% of the tile
JITTER = 3.0
MARGIN = 50
ATOL = 1e-3                           # f32 blur sums, as test_pallas.py
PEAK_FLOPS = 67e12                    # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12                  # H100 SXM HBM3
# kernel -> (source under feabas_tpu_torch/csrc, the TPU code it replaces)
KERNELS = {
    'dog_filter': ('dog_filter', 'feabas_tpu/ops/pallas_kernels.py:59'),
    'gaussian_blur': ('dog_filter', 'feabas_tpu/ops/pallas_kernels.py:25'),
    'mesh_raster': ('mesh_raster', 'feabas_tpu/ops/render.py:160'),
    'peak_detect': ('peak_detect', 'feabas_tpu/ops/lradon.py:48'),
    'lradon_patch': ('lradon_patch', 'feabas_tpu/ops/lradon.py:207'),
    'lradon_match': ('lradon_match', 'feabas_tpu/ops/lradon.py:301'),
    'montage_blend': ('montage_blend', 'feabas_tpu/ops/montage_render.py:62'),
    'fem_operator': ('fem_operator', 'feabas_tpu/optimizer.py:1192'),
    # no TPU kernel: the JAX package fits these shifts on the host
    'subpixel_refine': ('subpixel_refine', 'feabas_tpu/thumbnail.py:464'),
    # no TPU kernel: the JAX package's LANCZOS renders go to cv2.remap
    'mesh_raster_lanczos4': ('mesh_raster', 'feabas_tpu/common.py:235'),
}
KERNEL_SOURCES = sorted({src for src, _ in KERNELS.values()})


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, iters=20, warm_s=0.1):
    """Mean ms per call of ``iters`` calls (CUDA events), after ``warm_s``
    seconds of calls, which bring an idle card's clock back up."""
    import torch
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        fn()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(flop, nbytes):
    """(seconds, 'operations' | 'bytes'): the least time the card needs for
    ``flop`` f32 operations and ``nbytes`` of HBM traffic."""
    t_ops, t_bytes = flop / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def dog_bound(shape, in_bytes, sigma, is_dog):
    """The DoG (4 passes) or blur (2 passes): one FMA (2 FLOP) per tap and
    pass, plus the DoG's subtraction; each input byte read once, one f32
    written per pixel."""
    from feabas_tpu_torch.ops.dog import gaussian_kernel1d
    px = math.prod(shape)
    taps = gaussian_kernel1d(sigma).size
    flop = px * ((4 if is_dog else 2) * taps * 2 + (1 if is_dog else 0))
    return bound(flop, px * (in_bytes + 4))


# the library blur sums in another order than the kernel and its plain
# version (f32, TF32 off): it computes the same function to this bound
LIBRARY_ATOL = 1e-2


def blur_library(sigma, dev, is_dog):
    """K1's function through PyTorch's library: a 'replicate' ``F.pad``
    (the kernel's nearest edges) and two ``F.conv2d`` with the 1-D taps,
    rows then columns (cuDNN TF32 is off, ``device.py``); the DoG as
    f0 - blur(f0) with f0 = blur(x)."""
    import torch
    import torch.nn.functional as F
    from feabas_tpu_torch.ops.dog import gaussian_kernel1d
    k = torch.as_tensor(gaussian_kernel1d(sigma), device=dev)
    r = (k.numel() - 1) // 2
    kx, ky = k.reshape(1, 1, 1, -1), k.reshape(1, 1, -1, 1)

    def blur(x):
        y = F.pad(x.to(torch.float32)[:, None], (r, r, r, r), mode='replicate')
        return F.conv2d(F.conv2d(y, kx), ky)[:, 0]

    def dog(x):
        f0 = blur(x)
        return f0 - blur(f0)
    return dog if is_dog else blur


def kernel_row(name, shape, what, err, ms, pms, bnd, library_ms=None):
    return {'name': name, 'shape': list(shape), 'what': what,
            'max_abs_err': err, 'ms': ms, 'plain_ms': pms,
            'bound_us': bnd[0] * 1e6, 'bound_by': bnd[1],
            'library_ms': library_ms}


def log_rows(rows, err_unit=''):
    """One [kernel] line per row. A raster row also has its device time
    per launch; its share of the bound reads from that, every other row's
    from the wrapper call."""
    for r in rows:
        line = (f'[kernel] {r["name"]} {tuple(r["shape"])} {r["what"]}: '
                f'max_abs_err={r["max_abs_err"]:.3e}{err_unit} '
                f'kernel_ms={r["ms"]:.4f} plain_ms={r["plain_ms"]:.4f} '
                f'bound_us={r["bound_us"]:.4g} ({r["bound_by"]}) ')
        if 'K' in r:
            line += (f'device_us={r["device_us"]:.2f} share(device time)='
                     f'{r["bound_us"] / r["device_us"]:.1%} K={r["K"]} '
                     f'real_per_cell={r["real_per_cell"]:.2f} '
                     f'kept_per_tile={r["kept_per_tile"]:.2f}')
        else:
            line += f'share={r["bound_us"] / 1e3 / r["ms"]:.1%}'
            if 'device_us' in r:
                line += (f' device_us={r["device_us"]:.2f} share(device '
                         f'time)={r["bound_us"] / r["device_us"]:.1%}')
        if 'kept_rows_per_cell' in r:
            line += (f' kept_rows_per_cell={r["kept_rows_per_cell"]:.2f} '
                     f'covered_per_px={r["covered_per_px"]:.3f}')
        if r.get('library_ms') is not None:
            line += f' library_ms={r["library_ms"]:.4f}'
        if 'close_rows' in r:
            line += f' close_rows={r["close_rows"]}'
        if r.get('first_ms') is not None:
            line += f' first_version_ms(recorded)={r["first_ms"]:.4f}'
        log(line)


def check_kernels(dev):
    """Phase 3: the DoG/blur kernel against its plain version at the
    stitch and align paths' shapes and at the edges of its two code paths
    (whole planes, halo tiles)."""
    import torch
    from feabas_tpu_torch.ops import dog
    from feabas_tpu_torch.ops.filters import masked_dog_filter
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    def rand_stack(shape, dtype):
        x = torch.rand(shape, generator=g, device=dev) * 255
        return x.to(torch.uint8) if dtype == torch.uint8 else x

    def check(shape, dtype, sigma, is_dog, what='', iters=20, library=True,
              device=False):
        x = rand_stack(shape, dtype)
        kernel = dog.dog_filter if is_dog else dog.gaussian_blur
        plain = dog.dog_filter_plain if is_dog else dog.gaussian_blur_plain
        want = plain(x, sigma)
        err = float((kernel(x, sigma) - want).abs().max())
        ms = cuda_time(lambda: kernel(x, sigma), iters)
        # a call near the host floor is mostly host time: the device's
        # share of it, from a CUDA-graph replay
        us = graph_time(lambda: kernel(x, sigma), iters) if device else None
        pms = cuda_time(lambda: plain(x, sigma), iters)
        lms = None
        if library:
            lib = blur_library(sigma, dev, is_dog)
            lerr = float((lib(x) - want).abs().max())
            if not lerr <= LIBRARY_ATOL:
                raise RuntimeError(f'the library blur {shape} sigma {sigma}: '
                                   f'max_abs_err {lerr} > {LIBRARY_ATOL}')
            lms = cuda_time(lambda: lib(x), iters)
        name = 'dog_filter' if is_dog else 'gaussian_blur'
        label = f'{str(dtype).replace("torch.", "")} sigma {sigma:.3g}' + what
        rows.append(kernel_row(name, shape, label, err, ms, pms,
                               dog_bound(shape, x.element_size(), sigma,
                                         is_dog), lms))
        if us is not None:
            rows[-1]['device_us'] = us

    # the stacks the stitch and align runs below launch (launches_by_shape).
    # Stitch: match blocks of 128^2, 96^2, 64^2 and 192^2 (f32 after the
    # warp, sigma 2.5), and the in-program coarse seed's pooled bands, one
    # pair per call (sigma 2.5 / pool 2: the DoG at 1.25, the mask term's
    # blur at 1.25 * sqrt 2), which are most of its launches; the PYRAMID
    # low band's blur of 1, 2 and 4 padded 4096^2 tiles at sigma 4. Align
    # (working mip 2, sigma 3.5): 96^2 and 24^2 blocks and the whole
    # 2048^2 region. Thumbnail: see below.
    for shape in ((384, 128, 128), (64, 128, 128), (2048, 96, 96),
                  (1536, 64, 64), (256, 64, 64)):
        check(shape, torch.float32, 2.5, True)
    check((512, 192, 192), torch.float32, 2.5, True, ', tiles')
    for shape in ((1, 224, 2016), (1, 1504, 256), (1, 224, 256)):
        check(shape, torch.float32, 1.25, True, ', pooled band')
        check(shape, torch.float32, 1.25 * 2 ** 0.5, False, ', pooled band')
    for n in (1, 2, 4):
        check((n, 4096, 4096), torch.float32, 4.0, False, ', tiles', iters=5,
              device=n == 4)
    check((512, 96, 96), torch.float32, 3.5, True)
    check((8192, 24, 24), torch.float32, 3.5, True, ', halo > plane')
    # nonlinear align (phase 7): the classic match loop's stacks of 128
    # blocks
    check((128, 96, 96), torch.float32, 3.5, True)
    check((128, 24, 24), torch.float32, 3.5, True, ', halo > plane')
    check((1, 2048, 2048), torch.float32, 3.5, True, ', tiles', device=True)
    # thumbnail (sigma 3.5): the detector's whole 2048^2 thumbnail (above)
    # and the refinement's blocks of 192^2 and 64^2
    check((128, 192, 192), torch.float32, 3.5, True, ', tiles')
    check((128, 64, 64), torch.float32, 3.5, True, device=True)
    # the subpixel refinement's whole uint8 thumbnails: 2048^2 (phase 6)
    # and 4096^2 (the shipped mip 6)
    check((1, 2048, 2048), torch.uint8, 3.5, True, ', tiles')
    check((1, 4096, 4096), torch.uint8, 3.5, True, ', tiles', iters=5)
    # reference stacks kept from earlier runs: 8 pairs x 128 blocks of
    # 128^2, 512^2 uint8 blocks, and the low band of all 6 tiles at once
    check((1024, 128, 128), torch.float32, 2.5, True)
    check((16, 512, 512), torch.uint8, 2.5, True, ', tiles')
    check((6, 4096, 4096), torch.float32, 4.0, False, ', tiles', iters=5)
    # edges of both code paths: one pixel, a 3-row strip, a whole plane
    # of more rows than a block has threads, a packed stack of 24^2
    # planes, tiles that do not divide 129x130, and the mask term's
    # largest radius (sigma 3.5 * sqrt 2: r = 20)
    for args in (((1, 1, 1), torch.float32, 2.5, True, ', 1x1'),
                 ((1, 3, 700), torch.uint8, 2.5, True, ', 3x700'),
                 ((1, 4000, 3), torch.float32, 2.5, True, ', 4000x3'),
                 ((4, 24, 24), torch.float32, 3.5, True, ', 24x24'),
                 ((2, 129, 130), torch.float32, 2.5, True, ', tiles 129x130'),
                 ((2, 129, 130), torch.float32, 3.5 * 2 ** 0.5, False,
                  ', tiles 129x130')):
        check(*args, library=False)
    # the in-program coarse seed's masked pooled band (1, h, w): the
    # masked DoG runs the DoG kernel and the blur kernel; held against the
    # CPU, timed alone (its plain time is the CPU's, not recorded)
    band = rand_stack((1, 1664, 384), torch.float32)
    mask = torch.zeros((1, 1664, 384), device=dev)
    mask[:, :1600, :350] = 1.0
    got = masked_dog_filter(band, 1.25, mask=mask)
    want = masked_dog_filter(band.cpu(), 1.25, mask=mask.cpu())
    err = float((got.cpu() - want).abs().max())
    ms = cuda_time(lambda: masked_dog_filter(band, 1.25, mask=mask))
    bd, bb = dog_bound((1, 1664, 384), 4, 1.25, True)
    bm, _ = dog_bound((1, 1664, 384), 4, 1.25 * 2 ** 0.5, False)
    rows.append(kernel_row('masked_dog_filter', (1, 1664, 384),
                           'float32 sigma 1.25, DoG + blur', err, ms,
                           float('nan'), (bd + bm, bb)))
    torch.cuda.synchronize()
    log_rows(rows)
    for r in rows:
        if not r['max_abs_err'] <= ATOL:
            raise RuntimeError(f'{r["name"]} {r["shape"]}: max_abs_err '
                               f'{r["max_abs_err"]} > {ATOL}')
    return rows


def _section_mesh(size, mesh_size, amp, period):
    """Equilateral section mesh over (0, 0, size, size) whose MOVING gear
    carries the smooth warp (amp px, period px) of the phase-5 stack."""
    import numpy as np
    from feabas_tpu_torch.mesh import Mesh
    m = Mesh.from_bbox((0, 0, size, size), cartesian=False,
                       mesh_size=mesh_size, resolution=4)
    v = m.vertices_w_offset('INITIAL')
    d = np.stack([amp * np.sin(2 * np.pi * v[:, 1] / period),
                  amp * np.cos(2 * np.pi * v[:, 0] / period)], -1)
    c = (v + d).mean(axis=0, keepdims=True)
    m.set_vertices(v + d - c, 'MOVING', offset=c)
    return m


# FLOP one output pixel of the raster needs: the coverage test of its
# covering triangle (two affine evaluations of fma + mul + add, their sum,
# three comparisons and the weight's: 13), its source coordinate (two
# affines: 8) rounded to 1/32 px (6), the bounds test (4), the bilinear
# corner and weights (10) and blend (11), the clamped u8 store (3)
RASTER_FLOP_PER_PX = 13 + 8 + 6 + 4 + 10 + 11 + 3
# ... and in the Lanczos-4 mode: the coverage test, the coordinate and its
# snap as above, the window's four bounds tests (4), 64 taps of a
# multiply-add and their 16 weight terms (144), the clamped u8 store (3)
RASTER_LANCZOS_FLOP_PER_PX = 13 + 8 + 6 + 4 + 144 + 3


def raster_bound(src, tabs, h, w, interp='linear'):
    """Bound of one raster batch, from what the function needs: bytes of the
    u8 output, one source pixel per output pixel (at most the source given)
    and the triangle tables, each read once; RASTER_FLOP_PER_PX (or
    RASTER_LANCZOS_FLOP_PER_PX) for each output pixel (one covering
    triangle tested)."""
    px = tabs.shape[0] * h * w
    nbytes = px + min(src.numel(), px) * src.element_size() + tabs.numel() * 4
    per_px = RASTER_LANCZOS_FLOP_PER_PX if interp == 'lanczos4' \
        else RASTER_FLOP_PER_PX
    return bound(per_px * px, nbytes)


def graph_time(fn, n=20):
    """Device microseconds per call of ``fn``: ``n`` calls captured in one
    CUDA graph and replayed (no host time between launches), timed with
    CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    return cuda_time(graph.replay, iters=10) / n * 1e3


def _pad_tables(tabs, cands=None):
    """Stack per-block tables (and cell candidates) as the engine's
    dispatch does: rows padded with inert rows to a power of two, padding
    candidates pointing at the last (inert) row."""
    import numpy as np
    from feabas_tpu_torch.ops import render
    Tp = max(t.shape[0] for t in tabs)
    Tp = render._align_up(1 << int(Tp - 1).bit_length(), render._CHUNK,
                          render._CHUNK)
    tt = np.zeros((len(tabs), Tp, 14), np.float32)
    tt[:, :, 2], tt[:, :, 12], tt[:, :, 13] = -2.0, -np.inf, -1.0
    for k, t in enumerate(tabs):
        tt[k, :t.shape[0]] = t
    if cands is None:
        return tt, None
    Kp = max(c.shape[-1] for c in cands)
    cd = np.full((len(tabs), cands[0].shape[0], Kp), Tp - 1, np.int32)
    for k, c in enumerate(cands):
        cd[k, :, :c.shape[-1]] = c
    return tt, cd


def _engine_of(mesh, dev, **kw):
    from feabas_tpu_torch.renderer import MeshRenderer
    return MeshRenderer.from_mesh(mesh, device=dev, **kw)._get_device_engine()


def _block_sel(eng, x0, y0, x1, y1):
    import numpy as np
    tb = eng._tb
    return np.nonzero((tb[:, 0] < x1) & (tb[:, 2] > x0) & (tb[:, 1] < y1)
                      & (tb[:, 3] > y0) & np.isfinite(eng._w))[0]


def _crop_blocks(eng, img, origins, size, halo=2):
    """Per-block source crops (one common bucket shape, reaching ``halo``
    px past the blocks' source coordinates), tables and cell candidates of
    ``size``^2 blocks at ``origins``, as
    ``DeviceRenderEngine.render_blocks`` prepares a batch."""
    import numpy as np
    from feabas_tpu_torch.ops import render
    sels = [_block_sel(eng, x0, y0, x0 + size, y0 + size)
            for x0, y0 in origins]
    boxes = []
    for sel in sels:
        ps = eng._Psrc[sel].reshape(-1, 2)
        lo = [int(np.floor(v)) - halo for v in ps.min(axis=0)]
        hi = [int(np.ceil(v)) + halo for v in ps.max(axis=0)]
        boxes.append((lo, [render._align_up(b - a, render._SRC_ALIGN,
                                            render._SRC_ALIGN)
                           for a, b in zip(lo, hi)]))
    sw = max(b[1][0] for b in boxes)
    sh = max(b[1][1] for b in boxes)
    crops, tabs, cands = [], [], []
    for (x0, y0), sel, (lo, _) in zip(origins, sels, boxes):
        crop = np.zeros((sh, sw), img.dtype)
        part = img[max(lo[1], 0):lo[1] + sh, max(lo[0], 0):lo[0] + sw]
        crop[max(-lo[1], 0):max(-lo[1], 0) + part.shape[0],
             max(-lo[0], 0):max(-lo[0], 0) + part.shape[1]] = part
        crops.append(crop)
        tabs.append(eng._table_for_block(sel, (x0, y0), tuple(lo), eng._w))
        cands.append(eng._cells_for_block(sel, (x0, y0), size, size))
    return crops, tabs, cands


def _quad_mesh(x0, y0, x1, y1, shift):
    """Two triangles over a rectangle, its MOVING gear shifted by
    ``shift`` px and sheared a little."""
    import numpy as np
    from feabas_tpu_torch.mesh import Mesh
    v = np.array([[x0, y0], [x1, y0], [x0, y1], [x1, y1]], np.float64)
    m = Mesh(v, np.array([[0, 1, 2], [1, 3, 2]]), resolution=4)
    moved = v + shift + 0.01 * (v - v.mean(axis=0))[:, ::-1]
    c = moved.mean(axis=0, keepdims=True)
    m.set_vertices(moved - c, 'MOVING', offset=c)
    return m


def raster_row(dev, name, args, geodesic=False, out_kind='u8', fillval=0.0,
               covered=True, iters=20, warm_s=0.1, edge=False,
               interp='linear'):
    """One row of the mesh raster in the sampling mode ``interp``:
    ``args`` = (src, tables, cands, h, w) on the card held bit-equal to the
    plain version with the expected coverage flags, then timed (call ms,
    device us per launch from a CUDA-graph replay, plain ms, bound, what
    the tile cull keeps). Returns (row, the kernel's output)."""
    import torch
    from feabas_tpu_torch.ops import render
    tile_h = render.kernel_tile_h()
    src, tabs, cands, h, w = args
    B = tabs.shape[0]

    def kernel():
        return render.raster_blocks(src, tabs, cands, fillval, h, w,
                                    geodesic, out_kind, interp=interp)

    def plain():
        return render.raster_blocks_plain(src, tabs, cands, fillval, h, w,
                                          geodesic, out_kind, interp=interp)
    (got,), cov = kernel()
    (want,), pcov = plain()
    torch.cuda.synchronize()
    diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
    err = float(diff.max())
    want_cov = [covered] * B if isinstance(covered, bool) else covered
    if not (torch.equal(got, want) and got.dtype == want.dtype
            and torch.equal(cov, pcov) and cov.dtype == torch.bool
            and cov.tolist() == list(want_cov)):
        raise RuntimeError(
            f'mesh_raster {name}: max diff {err}, '
            f'{float((diff > 0).float().mean()):.2e} of pixels differ, '
            f'coverage {cov.tolist()} vs plain {pcov.tolist()}, expected '
            f'{list(want_cov)}')
    ms = cuda_time(kernel, iters, warm_s)
    pms = cuda_time(plain, max(iters // 4, 2), warm_s)
    run, _, dt = render._prepare(src, tabs, cands, fillval, h, w,
                                 geodesic, out_kind, None, interp)
    into = (torch.empty((B, h, w), dtype=dt, device=dev),
            torch.empty(B, dtype=torch.bool, device=dev))
    us = graph_time(lambda: run(*into))
    keep = render.tile_cull_plain(tabs, cands, h, w, tile_h)
    idx = (cands.long() if cands is not None else
           torch.arange(tabs.shape[1], device=dev)[None, None]
           .expand(B, 1, -1))
    real = torch.isfinite(
        tabs[torch.arange(B, device=dev)[:, None, None], idx][..., 12])
    row = kernel_row('mesh_raster_lanczos4' if interp == 'lanczos4'
                     else 'mesh_raster', (B, h, w), name, err, ms, pms,
                     raster_bound(src, tabs, h, w, interp))
    row.update(edge=edge, device_us=us, K=int(keep.shape[-1]),
               real_per_cell=float(real.sum(-1).float().mean()),
               kept_per_tile=float(keep.sum(-1).float().mean()))
    return row, got


def check_raster(dev, texture):
    """Phase 3, mesh raster: the kernel against its plain version, 0 LSB
    and equal coverage flags everywhere.

    Timed rows (wrapper call, device time per launch, plain version,
    bound, and what the tile cull removes): (a) 1, 2, 3 and 4 x 2048^2
    blocks with cell-binned tables from a deformed section mesh (mesh_size
    600 on an 8192^2 section), each with its own source crop: the align
    path's batches, the same blocks' 1 and 4 at LANCZOS (the Lanczos-4
    mode, crops reaching its halo: the align render cell's batches), and
    three 1536^2 blocks, the thumbnail path's; (b) four 512^2 flat-table blocks against one resident
    source; (c) two identical triangles with equal weights, where the
    first row must win. Edges (checked, timed briefly): flat tables at
    1x1, 3x5 and 130x70 with u16 and f32 outputs, an f32 source, a folded
    mesh with the geodesic mask (flat and cells), a cell with only padding
    candidates and a block with no real row at all, K = 4 and K = 32, a
    flat table walked in chunks, and a block whose real rows all lie in
    one corner tile. Then the batch upload: staged through the reused
    page-locked buffer against a plain copy from pageable memory."""
    import numpy as np
    import torch
    from feabas_tpu_torch import state
    from feabas_tpu_torch.dal import StreamLoader
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.ops import render
    img = texture[:8192, :8192]
    mesh = _section_mesh(8192, 600, 8.0, 2048.0)
    loader = StreamLoader(img)
    eng = _engine_of(mesh, dev)
    rows = []

    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(dev)

    def compare(name, args, geodesic=False, out_kind='u8', fillval=0.0,
                covered=True, iters=20, warm_s=0.1, edge=False,
                interp='linear'):
        row, got = raster_row(dev, name, args, geodesic, out_kind, fillval,
                              covered, iters, warm_s, edge, interp)
        rows.append(row)
        return got

    # (a) the align path's batches: 1-4 x 2048^2 blocks, cells, own crops
    origins = [(3072, 3072), (1024, 3072), (3072, 1024), (5120, 5120)]
    crops, tabs, cands = _crop_blocks(eng, img, origins, 2048)
    batches = {}
    for n in (1, 2, 3, 4):
        tt, cd = _pad_tables(tabs[:n], cands[:n])
        batches[n] = (np.stack(crops[:n]), tt, cd)
        compare(f'{n} x 2048^2 cells, own crops' if n > 1
                else '2048^2 cells, own crop',
                (t(batches[n][0]), t(tt), t(cd), 2048, 2048),
                iters=20 if n == 1 else 10)
    # the align render cell's batches at LANCZOS: 1 and 4 x 2048^2 blocks,
    # cells, crops reaching the Lanczos-4 halo
    crops_l, tabs_l, cands_l = _crop_blocks(
        eng, img, origins, 2048, halo=render._SRC_HALO['lanczos4'])
    for n in (1, 4):
        tt, cd = _pad_tables(tabs_l[:n], cands_l[:n])
        compare(f'{n} x 2048^2 cells, own crops, Lanczos-4',
                (t(np.stack(crops_l[:n])), t(tt), t(cd), 2048, 2048),
                iters=10, interp='lanczos4')
    # the thumbnail path's render batches: 3 x 1536^2 blocks
    crops3, tabs3, cands3 = _crop_blocks(
        eng, img, [(1024, 1024), (2560, 1024), (1024, 2560)], 1536)
    tt, cd = _pad_tables(tabs3, cands3)
    compare('3 x 1536^2 cells, own crops',
            (t(np.stack(crops3)), t(tt), t(cd), 1536, 1536), iters=10)
    # (b) 4 x 512^2 flat tables, one resident source
    resident, origin = eng._resident_source(loader, 0)
    flat = [eng._table_for_block(_block_sel(eng, bx, by, bx + 512, by + 512),
                                 (bx, by), origin, eng._w)
            for bx, by in ((1024, 5120), (1536, 5120), (1024, 5632),
                           (1536, 5632))]
    tt, _ = _pad_tables(flat)
    compare('4 x 512^2 flat, resident source', (resident, t(tt), None, 512,
                                                512))
    # (c) two identical always-inside rows with equal weight and different
    # affines: the first must win every pixel
    A = np.eye(2)
    first = eng._table_affine(A, np.array([10.0, 10.0]), (0, 0), (0, 0))
    tie = first.copy()
    tie[1] = eng._table_affine(A, np.array([20.0, 5.0]), (0, 0), (0, 0))[0]
    src = t(img[:1024, :1024])
    got = compare('tie, 512^2', (src, t(tie[None]), None, 512, 512))
    alone, _ = render.raster_blocks(src, t(first[None]), None, 0.0, 512, 512,
                                    False, 'u8')
    if not torch.equal(got, alone[0]):
        raise RuntimeError('mesh_raster tie: the first row did not win')

    # the kernel's edges
    def edge(name, args, **kw):
        compare(name, args, iters=8, warm_s=0.02, edge=True, **kw)

    one = t(flat[0][None])
    for h, w in ((1, 1), (3, 5), (130, 70)):
        for kind in ('u16', 'f32'):
            edge(f'flat {h}x{w}, {kind} out', (resident, one, None, h, w),
                 out_kind=kind)
    edge('flat 130x70, f32 source, u8 out',
         (resident.to(torch.float32) * 0.5, one, None, 130, 70))
    edge('4 x 512^2 flat, f32 source, f32 out, fill 7',
         (resident.to(torch.float32) * 0.5, t(tt), None, 512, 512),
         out_kind='f32', fillval=7.0)
    # a folded mesh (x > 340 mirrored back) with the geodesic mask
    fm = Mesh.from_bbox((0, 0, 512, 256), cartesian=True, mesh_size=40,
                        resolution=4)
    v = fm.vertices('FIXED').copy()
    v[v[:, 0] > 340, 0] = 680 - v[v[:, 0] > 340, 0]
    fm.set_vertices(v, 'MOVING')
    fimg = np.ascontiguousarray(img[:256, :512])
    floader = StreamLoader(fimg)
    feng = _engine_of(fm, dev, image_loader=floader, mode='LEAST_DEFORM',
                      geodesic_mask=True)
    if not feng._geodesic:
        raise RuntimeError('the folded mesh has no fold sheets')
    fres, forigin = feng._resident_source(floader, 0)
    fsel = _block_sel(feng, 0, 0, 512, 256)
    ftab = feng._table_for_block(fsel, (0, 0), forigin, feng._w)
    fcand = feng._cells_for_block(fsel, (0, 0), 256, 512)
    edge('fold, geodesic, 256x512 flat', (fres, t(ftab[None]), None, 256, 512),
         geodesic=True)
    edge('fold, geodesic, 256x512 cells',
         (fres, t(ftab[None]), t(fcand[None]), 256, 512), geodesic=True)
    # one cell with only padding candidates; a block with no real row
    hole = batches[1][2].copy()
    hole[0, 5 * 16 + 7] = batches[1][1].shape[1] - 1
    edge('2048^2 cells, one cell all padding, fill 7',
         (t(batches[1][0]), t(batches[1][1]), t(hole), 2048, 2048),
         fillval=7.0)
    empty = np.stack([flat[0], np.zeros_like(flat[0])])
    empty[1, :, 2], empty[1, :, 12], empty[1, :, 13] = -2.0, -np.inf, -1.0
    edge('2 x 512^2 flat, second block all padding, fill 7',
         (resident, t(empty), None, 512, 512), fillval=7.0,
         covered=[True, False])
    # K = 4 (two triangles), K = 32 and a flat table of more than 256 rows
    # (mesh_size 50 on a 2048^2 section)
    qimg = np.ascontiguousarray(img[:1024, :1024])
    qeng = _engine_of(_quad_mesh(-8, -8, 1032, 1032, (6.0, 4.0)), dev)
    qsel = _block_sel(qeng, 0, 0, 1024, 1024)
    qtab = qeng._table_for_block(qsel, (0, 0), (0, 0), qeng._w)
    qcand = qeng._cells_for_block(qsel, (0, 0), 1024, 1024)
    if qcand.shape[-1] != 4:
        raise RuntimeError(f'two triangles gave K = {qcand.shape[-1]}')
    edge('1024^2 cells, K = 4', (t(qimg), t(qtab[None]), t(qcand[None]), 1024,
                                 1024))
    deng = _engine_of(_section_mesh(2048, 50, 4.0, 512.0), dev)
    dcrops, dtabs, dcands = _crop_blocks(deng, img, [(512, 512)], 512)
    if dcands[0].shape[-1] != 32 or dtabs[0].shape[0] <= 256:
        raise RuntimeError(f'mesh_size 50 gave K = {dcands[0].shape[-1]} and '
                           f'{dtabs[0].shape[0]} rows')
    edge('512^2 cells, K = 32',
         (t(dcrops[0][None]), t(dtabs[0][None]), t(dcands[0][None]), 512, 512))
    edge(f'512^2 flat, {dtabs[0].shape[0]} rows in chunks',
         (t(dcrops[0][None]), t(dtabs[0][None]), None, 512, 512))
    # every real row inside the first tile (the top-left 128 x 8 px)
    ceng = _engine_of(_quad_mesh(2, 1, 100, 7, (3.0, 2.0)), dev)
    csel = _block_sel(ceng, 0, 0, 512, 512)
    ctab = ceng._table_for_block(csel, (0, 0), (0, 0), ceng._w)
    ccand = ceng._cells_for_block(csel, (0, 0), 512, 512)
    edge('512^2 flat, rows in one corner tile',
         (t(qimg), t(ctab[None]), None, 512, 512))
    edge('512^2 cells, rows in one corner tile',
         (t(qimg), t(ctab[None]), t(ccand[None]), 512, 512))
    torch.cuda.synchronize()
    log_rows(rows, ' LSB')

    # the batch upload: one reused page-locked staging buffer against a
    # copy from pageable memory, for the 1- and 4-block batches above
    for n in (1, 4):
        crop_list = crops[:n]
        tt, cd = batches[n][1], batches[n][2]

        def staged():
            return state.render_batch_to_device(crop_list, tt, cd, dev)

        def pageable():
            return (torch.from_numpy(np.stack(crop_list)).to(dev),
                    torch.from_numpy(tt).to(dev), torch.from_numpy(cd).to(dev))
        for a, b in zip(staged(), pageable()):
            if not torch.equal(a, b):
                raise RuntimeError('the staged upload changed the bytes')
        held = torch.empty(np.stack(crop_list).shape, dtype=torch.uint8,
                           pin_memory=True)
        dst = torch.empty(held.shape, dtype=torch.uint8, device=dev)
        dma = cuda_time(lambda: dst.copy_(held, non_blocking=True), 10)
        line = f'[upload] {n} x {crop_list[0].shape} u8 crops + tables:'
        for name, fn in (('pageable', pageable), ('staged', staged),
                         ('staged', staged), ('pageable', pageable)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            host = (time.perf_counter() - t0) / 10 * 1e3
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 10 * 1e3
            line += f' {name} host {host:.3f} ms, to sync {wall:.3f} ms;'
        log(line + f' device time of the crops\' copy from page-locked '
            f'memory {dma:.3f} ms')
    return rows



# ------------------- phase 3: the stitch path's montage blend ------------------- #

# FLOP of the montage blend, from what the function needs. Per table row
# that survives the cell cull, at each pixel of its cell, the inside test
# (two affines of two products and two sums, their sum, three comparisons
# and the weight's): 13. Per (pixel, covering tile): the source coordinate
# (two affines: 8) rounded to 1/32 px (6), the bounds test (4), the
# bilinear base and fractions (10), the sample (11), gain and offset (2),
# the border weight (8) and the blend (3): 52; PYRAMID adds the low band's
# sample, gain and offset, the compare and the high band: 15. Per output
# pixel the normalisation, the fill and the rounding: 7.
MONTAGE_ROW_FLOP = 13
MONTAGE_COVER_FLOP = 52
MONTAGE_PYRAMID_FLOP = 15
MONTAGE_OUT_FLOP = 7


class TileStack:
    """In-memory tiles at world positions, read as the montage engine reads
    a section's loader (through ``dal.TileView``)."""
    dtype = 'uint8'
    number_of_channels = 1
    default_fillval = 0

    def __init__(self, tiles, origins):
        import numpy as np
        self.tiles = tiles
        self.bboxes = np.asarray([(x, y, x + t.shape[1], y + t.shape[0])
                                  for t, (x, y) in zip(tiles, origins)],
                                 np.float64)

    def crop(self, bbox, fileid=None, return_empty=False, **kwargs):
        x0, y0 = self.bboxes[fileid, :2]
        return self.tiles[fileid][int(bbox[1] - y0):int(bbox[3] - y0),
                                  int(bbox[0] - x0):int(bbox[2] - x0)]


def tile_meshes(sizes, origins, mesh_size, bd_width=None, cartesian=None,
                shear=5e-4, scale=1.0, turn=0.0):
    """Tile meshes as the stitcher builds them (``Mesh.from_boarder_bbox``,
    INITIAL tile-local; ``Mesh.from_bbox`` where ``cartesian`` is given),
    MOVING at ``origins`` with a slight shear, then scaled by ``scale`` and
    turned by ``turn`` degrees about the tile's centre."""
    import numpy as np
    from feabas_tpu_torch.mesh import Mesh
    out = []
    for k, ((w, h), (x, y)) in enumerate(zip(sizes, origins)):
        if cartesian is None:
            m = Mesh.from_boarder_bbox((0, 0, w, h), bd_width=bd_width or np.inf,
                                       mesh_size=mesh_size, resolution=4, uid=k)
        else:
            m = Mesh.from_bbox((0, 0, w, h), cartesian=cartesian,
                               mesh_size=mesh_size, resolution=4, uid=k)
        v = m.vertices('INITIAL')
        moved = v + np.asarray([x, y]) + shear * (v - v.mean(axis=0))[:, ::-1]
        c = moved.mean(axis=0, keepdims=True)
        if scale != 1.0 or turn != 0.0:
            a = np.deg2rad(turn)
            rot = scale * np.array([[np.cos(a), -np.sin(a)],
                                    [np.sin(a), np.cos(a)]])
            moved = (moved - c) @ rot.T + c
        m.set_vertices(moved - c, 'MOVING', offset=c)
        out.append(m)
    return out


def montage_block(dev, tiles, origins, meshes, bbox, blend, fillval=0.0,
                  transfers=None):
    """The montage engine's inputs for one output block of the section
    made of ``tiles`` at ``origins`` under ``meshes``:
    ``(montage_blend args, H, W)``."""
    from feabas_tpu_torch.stitcher import MontageRenderer
    mr = MontageRenderer(meshes, TileStack(tiles, origins), device=dev,
                         blend=blend, tile_transfers=transfers)
    eng = mr._montage_device_engine()
    out = eng.block_inputs(bbox, mr._index.query(bbox), blend, fillval)
    if out is None or out is NotImplemented:
        raise RuntimeError(f'block {bbox}: no device blend ({out})')
    return out


def montage_cases(dev):
    """[(name, thunk)] of the montage blend's phase-3 cases, the edges of
    its design. A thunk makes the case on ``dev``: a dict with the
    wrapper's ``args``, ``covered`` (the flag it must give) and, for some,
    ``post`` (a further check of the kernel's output)."""
    import torch
    from feabas_tpu_torch.ops import montage_render as mrd
    grid = {}

    def section():
        # phase 4's 2x3 grid, tile meshes as its optimization builds them
        # (low strain: mesh_size 300, border band 300 px = the median
        # overlap width), at the true positions, corner at (1, 1)
        if not grid:
            world, tiles, true_bb, _ = make_grid(dev)
            origins = true_bb[:, :2] - true_bb[:, :2].min(axis=0) + 1.0
            grid.update(world=world, tiles=tiles, origins=origins,
                        meshes=tile_meshes([(TILE_W, TILE_H)] * len(tiles),
                                           origins, 300, bd_width=300))
        return grid

    def block(bbox, blend, fillval=0.0, out_kind='u8'):
        def make():
            g = section()
            args, _, _ = montage_block(dev, g['tiles'], g['origins'],
                                       g['meshes'], bbox, blend, fillval)
            return {'args': args[:9] + (out_kind,) + args[10:],
                    'covered': True}
        return make

    def nothing():
        args = block((0, 0, 4096, 4096), 'PYRAMID')()['args']
        cands = torch.full_like(args[5], -1)
        return {'args': args[:5] + (cands, 17.0) + args[7:], 'covered': False}

    def tie():
        # two tiles of one geometry and different images, both low bands
        # the first's: the first must win the high band everywhere, so the
        # pair renders exactly as the first tile alone
        w = section()['world']
        a, b = w[100:612, 200:712], w[1000:1512, 3000:3512]
        meshes = tile_meshes([(512, 512)] * 2, [(20.5, 10.25)] * 2, 100)
        args, _, _ = montage_block(dev, [a, b], [(0, 0), (0, 0)], meshes,
                                   (0, 0, 576, 576), 'PYRAMID')
        srcs, lows, gmap, tables, aux, cands = args[:6]
        if not bool((cands[:, 1] == 1).any()):
            raise RuntimeError('tie: no cell holds both tiles')
        both = args[:1] + (lows[[0, 0]],) + args[2:9] + ('f32',) + args[10:]

        def alone(i):
            one = torch.where(cands == 0, 0, -1)[:, :1].contiguous()
            return mrd.montage_blend_plain(
                srcs[i:i + 1], lows[:1], gmap[:1], tables[:1], aux[:1], one,
                0.0, *args[7:9], 'f32', True)[0]

        def post(got):
            if not torch.equal(got[0], alone(0)):
                raise RuntimeError('tie: the first tile did not win')
            if torch.equal(got[0], alone(1)):
                raise RuntimeError('tie: both tiles render alike')
        return {'args': both, 'covered': True, 'post': post}

    def dense():
        # one 1024^2 tile on a 40-px cartesian mesh: more than 1000 rows,
        # streamed through shared memory in chunks of 256
        w = section()['world']
        meshes = tile_meshes([(1024, 1024)], [(-3.5, 7.25)], 40,
                             cartesian=True)
        args, _, _ = montage_block(dev, [w[:1024, :1024]], [(0, 0)], meshes,
                                   (0, 0, 1024, 1024), 'PYRAMID')
        if args[3].shape[1] < 1000:
            raise RuntimeError(f'dense mesh: {args[3].shape[1]} rows')
        return {'args': args, 'covered': True}

    def kcap():
        # K_CAP tiles of 64^2 over one corner: its cell holds all of them
        # (and the section, at K_CAP tiles, takes the resident stack)
        w = section()['world']
        n = mrd.K_CAP
        origins = [(0.37 * i, 0.21 * i) for i in range(n)]
        tiles = [w[7 * i:7 * i + 64, 11 * i:11 * i + 64] for i in range(n)]
        meshes = tile_meshes([(64, 64)] * n, origins, 40)
        args, _, _ = montage_block(dev, tiles, origins, meshes,
                                   (0, 0, 256, 192), 'PYRAMID',
                                   transfers=[(1.0 + 0.01 * i, i % 5 - 2.0)
                                              for i in range(n)])
        if args[5].shape[1] != n:
            raise RuntimeError(f'K = {args[5].shape[1]}, not {n}')
        return {'args': args, 'covered': True}

    def turned():
        # one 1024^2 tile shown at half size and turned by 30 degrees: a
        # warp's 32 adjacent pixels sample 64 source pixels along a slant
        w = section()['world']
        meshes = tile_meshes([(1024, 1024)], [(0.0, 0.0)], 100, scale=0.5,
                             turn=30.0)
        args, _, _ = montage_block(dev, [w[2000:3024, 1000:2024]], [(0, 0)],
                                   meshes, (0, 0, 1024, 1024), 'PYRAMID')
        return {'args': args, 'covered': True}

    def ragged_grid():
        # 20 x 17 cells, 680 half-cell units: more than one pass of the
        # kernel's persistent grid and not a multiple of it
        mk = block((700.25, 500.5, 1980, 1588), 'PYRAMID')
        case = mk()
        attrs = mrd.kernel_attrs(True)
        grid = (attrs['blocks_per_sm']
                * torch.cuda.get_device_properties(dev).multi_processor_count)
        units = 2 * case['args'][5].shape[0]
        if not (units > grid and units % grid):
            raise RuntimeError(f'{units} units against a grid of {grid}')
        return case

    return [('4096^2 LINEAR', block((0, 0, 4096, 4096), 'LINEAR')),
            ('ragged 1338 x 1000, PYRAMID',
             block((3000.5, 2000.25, 4337.5, 2999.25), 'PYRAMID')),
            ('ragged 1338 x 1000, LINEAR, f32 out',
             block((3000.5, 2000.25, 4337.5, 2999.25), 'LINEAR',
                   out_kind='f32')),
            ('cells without a tile, fill 17',
             block((-1500, -1000, 548, 1048), 'PYRAMID', fillval=17.0)),
            ('no tile in any cell, fill 17', nothing),
            ('identical tiles, the first wins', tie),
            ('dense mesh, R >= 1000', dense),
            ('K = K_CAP', kcap),
            ('tile scaled by 0.5, turned by 30 degrees', turned),
            ('one cell, 64 x 64', block((2500, 1500, 2564, 1564), 'PYRAMID')),
            ('cells not a multiple of the grid', ragged_grid)]


def montage_compare(case):
    """One launch of the montage blend on a case of ``montage_cases``
    against the plain version: bit-equal output and covered flag, the
    flag as the case expects. Returns the output."""
    import torch
    from feabas_tpu_torch.ops import montage_render as mrd
    args = case['args']
    got = mrd.montage_blend(*args)
    want = mrd.montage_blend_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and got[0].dtype == want[0].dtype
            and got[1] == want[1] == case['covered']):
        diff = (got[0].to(torch.float64) - want[0].to(torch.float64)).abs()
        raise RuntimeError(
            f'montage_blend: max diff {float(diff.max())}, '
            f'{float((diff > 0).float().mean()):.2e} of pixels differ, '
            f'covered {got[1]} vs plain {want[1]}, expected {case["covered"]}')
    if case.get('post') is not None:
        case['post'](got)
    return got


def montage_bound(args):
    """Bound of one block from its inputs: the output, one source byte per
    (pixel, covering tile) (two with PYRAMID) and the tables, each once;
    the FLOP of the rows the cell cull keeps, the covered samples and the
    output (MONTAGE_*_FLOP)."""
    from feabas_tpu_torch.ops import montage_render as mrd
    srcs, lows, gmap, tables, aux, cands, fillval, ncy, ncx, out_kind, \
        pyramid = args
    px = ncy * ncx * mrd.CELL ** 2
    kept = int(mrd.cell_cull_plain(tables, cands, ncx).sum())
    cov = mrd.covered_pixels_plain(tables, cands, ncx)
    nbytes = (px * (1 if out_kind == 'u8' else 4) + cov * (2 if pyramid else 1)
              + 4 * (tables.numel() + aux.numel()) + 8 * (cands.numel()
                                                          + gmap.numel()))
    flop = (kept * mrd.CELL ** 2 * MONTAGE_ROW_FLOP + px * MONTAGE_OUT_FLOP
            + cov * (MONTAGE_COVER_FLOP
                     + (MONTAGE_PYRAMID_FLOP if pyramid else 0)))
    return bound(flop, nbytes), kept, cov


def montage_row(dev, name, case, path=False):
    """One row of the montage blend: ``case`` (see ``montage_cases``) held
    bit-equal to the plain version, then timed: call ms, device us per
    launch from a CUDA-graph replay, plain ms and bound (none of PyTorch's
    library calls rasterizes and blends tiles). A block of the stitch path
    (``path``) is timed longer than an edge."""
    import torch
    from feabas_tpu_torch.ops import montage_render as mrd
    args = case['args']
    montage_compare(case)
    iters, warm = (10, 0.1) if path else (3, 0.01)
    ms = cuda_time(lambda: mrd.montage_blend(*args), iters, warm)
    pms = cuda_time(lambda: mrd.montage_blend_plain(*args), 2 if path else 1,
                    warm)
    run, shape, dt = mrd._prepare(*args)
    into = (torch.empty(shape, dtype=dt, device=dev),
            torch.empty(1, dtype=torch.bool, device=dev))
    us = graph_time(lambda: run(*into), 20 if path else 5)
    bnd, kept, cov = montage_bound(args)
    C, K = args[5].shape
    row = kernel_row('montage_blend', (C, K, args[3].shape[1]), name, 0.0,
                     ms, pms, bnd)
    row.update(edge=not path, device_us=us, kept_rows_per_cell=kept / C,
               covered_per_px=cov / (C * mrd.CELL ** 2))
    torch.cuda.synchronize()
    return row


def check_montage(dev):
    """Phase 3, the montage blend on its edges: every case of
    ``montage_cases`` bit-equal to the plain version with the expected
    covered flag, each timed (``montage_row``). The stitch path's own
    blocks are held so in phase 4 (``montage_path_rows``)."""
    from feabas_tpu_torch.ops import montage_render as mrd
    for pyr in (False, True):
        for kind in ('u8', 'f32'):
            log(f'[kernel] montage_blend {"PYRAMID" if pyr else "LINEAR"} '
                f'{kind}: {mrd.kernel_attrs(pyr, kind)}')
    rows = [montage_row(dev, name, make()) for name, make in montage_cases(dev)]
    log_rows(rows, ' LSB')
    return rows


def stitch_blocks(wd, lut=None):
    """The montage blend's inputs for each output block that the stitch
    CLI's rendering stage blended on work dir ``wd``, rebuilt as that stage
    built them: the section's tform, the render settings, the plan of
    output blocks and the engine calls of
    ``MontageRenderer.render_tile_list``; with ``lut`` (renderer -> LUT)
    after ``add_transfer_functions`` of its LUT. Yields (file name, bbox,
    blend, ``montage_blend`` args, H, W)."""
    from feabas_tpu_torch import config
    from feabas_tpu_torch.stitcher import MontageRenderer
    rconf = config.stitch_configs().get('rendering', {})
    mr = MontageRenderer.from_h5(
        os.path.join(wd, 'stitch', 'tform', 's0001.h5'),
        loader_config=rconf.get('loader_settings') or {},
        **(rconf.get('render_settings') or {}))
    if lut is not None:
        mr.add_transfer_functions(lut(mr))
    eng = mr._montage_device_engine()
    blend = str(mr._blend).upper()
    names = rconf.get('filename_settings') or {}
    for fname, bbox in mr.plan_render_series(
            tile_size=tuple(rconf.get('tile_size', (4096, 4096))),
            pattern=names.get('pattern', '_tr{ROW_IND}-tc{COL_IND}.png'),
            one_based=names.get('one_based', True), prefix=mr.name or 'section'):
        hits = mr._index.query(bbox)
        inputs = eng.block_inputs(bbox, hits, blend,
                                  float(mr.loader.default_fillval)) \
            if hits.size else None
        if inputs is not None and inputs is not NotImplemented:
            yield (fname, bbox, blend) + inputs


def montage_path_rows(dev, wd, launched):
    """The montage blend on every block of ``stitch_blocks``, each held
    bit-equal to the plain version and timed (``montage_row``). Fails
    unless those blocks have the (C, K, R) shapes ``launched`` ({'CxKxR':
    launches}), as many times each."""
    rows, shapes = [], {}
    for _, bbox, blend, args, _, _ in stitch_blocks(wd):
        key = 'x'.join(map(str, (*args[5].shape, args[3].shape[1])))
        shapes[key] = shapes.get(key, 0) + 1
        rows.append(montage_row(
            dev, f'stitch block at ({bbox[0]}, {bbox[1]}), {blend}',
            {'args': args, 'covered': True}, path=True))
        del args
    if shapes != launched:
        raise RuntimeError(f'the stitch blocks rebuilt have shapes {shapes}, '
                           f'the rendering stage launched {launched}')
    log_rows(rows, ' LSB')
    return rows


def make_texture(dev, H, W, seed=SEED, blur=2.0):
    """Band-limited uint8 texture (H, W) on the card: seeded normal noise,
    Gaussian blur (sigma ``blur`` px), mean 128, std 40."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((1, 1, H, W), generator=g, device=dev)
    r = int(4 * blur)
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1, device=dev) / blur) ** 2)
    k = k / k.sum()
    img = F.conv2d(F.pad(noise, (r, r, r, r), mode='reflect'),
                   k.reshape(1, 1, 1, -1))
    img = F.conv2d(img, k.reshape(1, 1, -1, 1))[0, 0]
    img = img / img.std() * 40.0 + 128.0
    return torch.clamp(img, 0, 255).to(torch.uint8)


def make_grid(dev):
    """World texture on the card (seeded), cut into a 2x3 grid with
    jittered true positions. Returns (world, tiles, true_bboxes,
    stage_bboxes) as host arrays."""
    import numpy as np
    H = 2 * MARGIN + ROWS * TILE_H - (ROWS - 1) * OVERLAP_Y
    W = 2 * MARGIN + COLS * TILE_W - (COLS - 1) * OVERLAP_X
    world = make_texture(dev, H, W).cpu().numpy()
    rng = np.random.default_rng(SEED)
    tiles, true_bb, stage_bb = [], [], []
    for rr in range(ROWS):
        for cc in range(COLS):
            x0 = MARGIN + cc * (TILE_W - OVERLAP_X)
            y0 = MARGIN + rr * (TILE_H - OVERLAP_Y)
            jx, jy = rng.normal(0, JITTER, 2) if (rr, cc) != (0, 0) else (0.0, 0.0)
            xt, yt = int(round(x0 + jx)), int(round(y0 + jy))
            tiles.append(world[yt:yt + TILE_H, xt:xt + TILE_W].copy())
            true_bb.append((xt, yt, xt + TILE_W, yt + TILE_H))
            stage_bb.append((x0, y0, x0 + TILE_W, y0 + TILE_H))
    return world, tiles, np.asarray(true_bb, float), np.asarray(stage_bb, float)


def _save_yaml(path, data):
    import yaml
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        yaml.safe_dump(data, f, default_flow_style=False)


def setup_workdir(root, tiles, stage_bb):
    """Config dir + work dir holding one section's tiles and coordinate
    file; points the config system at it (before any config is read)."""
    import cv2
    cfg = os.path.join(root, 'configs')
    shutil.copytree(os.path.join(REPO, 'configs'), cfg)
    wd = os.path.join(root, 'work_dir')
    _save_yaml(os.path.join(cfg, 'general_configs.yaml'), {
        'working_directory': wd, 'parallel_framework': 'serial',
        'full_resolution': 4, 'section_thickness': 30,
        'logfile_level': 'NONE', 'archive_level': 'NONE',
        'console_level': 'WARNING', 'device': {'render': 'auto'}})
    tdir = os.path.join(wd, 'raw', 's0001')
    os.makedirs(tdir)
    lines = ['{ROOT_DIR}\t' + tdir, '{RESOLUTION}\t4']
    for k, (tile, sb) in enumerate(zip(tiles, stage_bb)):
        fn = f'tile_{k:03d}.png'
        if not cv2.imwrite(os.path.join(tdir, fn), tile):
            raise OSError(f'could not write {fn}')
        lines.append(f'{fn}\t{sb[0]:.0f}\t{sb[1]:.0f}\t{sb[2]:.0f}\t{sb[3]:.0f}')
    coord = os.path.join(wd, 'stitch', 'stitch_coord', 's0001.txt')
    os.makedirs(os.path.dirname(coord))
    with open(coord, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    _save_yaml(os.path.join(wd, 'configs', 'stitching_configs.yaml'), {
        'matching': {'num_workers': 1},
        'rendering': {'num_workers': 1,
                      'loader_settings': {'apply_CLAHE': False,
                                          'inverse': False}}})
    os.environ['FEABAS_TPU_CONFIG_DIR'] = cfg
    from feabas_tpu_torch import config
    config.clear_config_caches()
    return wd


def read_rendered(out_dir, bbox):
    """Crop ``bbox`` (x0, y0, x1, y1) of the rendered section from the
    output tiles listed in its metadata.txt (zero where none)."""
    import cv2
    import numpy as np
    x0, y0, x1, y1 = bbox
    out = np.zeros((y1 - y0, x1 - x0), np.uint8)
    with open(os.path.join(out_dir, 'metadata.txt')) as f:
        rows = [ln.rstrip('\n').split('\t') for ln in f if not ln.startswith('{')]
    for fname, *b in rows:
        tx0, ty0, tx1, ty1 = (int(float(v)) for v in b)
        ix0, iy0, ix1, iy1 = max(x0, tx0), max(y0, ty0), min(x1, tx1), min(y1, ty1)
        if ix1 <= ix0 or iy1 <= iy0:
            continue
        img = cv2.imread(os.path.join(out_dir, fname), cv2.IMREAD_UNCHANGED)
        out[iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0] = \
            img[iy0 - ty0:iy1 - ty0, ix0 - tx0:ix1 - tx0]
    return out


def stitch_stages(profile=False, before=None):
    """Seconds of the stitch CLI's matching, optimization and rendering on
    the work dir ``setup_workdir`` made, each stage ended by a synchronize;
    with ``profile`` each in one torch.profiler pass (``_profiled``);
    ``before(mode)`` is called before each stage."""
    import torch
    from feabas_tpu_torch.scripts import stitch_main
    stage_s = {}
    for mode in ('matching', 'optimization', 'rendering'):
        if before is not None:
            before(mode)
        t = time.perf_counter()
        _profiled(profile, f'stitch.{mode}',
                  lambda: stitch_main.main(['--mode', mode]))
        torch.cuda.synchronize()
        stage_s[mode] = time.perf_counter() - t
    return stage_s


def run_slice(dev, profile=False, keep=None):
    """Phase 4: the stitch path at full size through the stitch CLI, then
    the montage blend held against its plain version on each block the
    path blended (and under seeded transfers), the ROI mask, the CG
    operator on the systems the path bound it to, and the path's first
    per-round match solve and fused ENG solve run again. Returns
    (launches, launches by shape, stage seconds, the blend's and the
    operator's rows). With ``keep`` (a dict) its work dir stays for phase 9,
    as ``keep['stitch']`` = (root, work dir)."""
    import numpy as np
    import torch
    import cv2
    from feabas_tpu_torch import device as device_mod
    from feabas_tpu_torch import optimizer
    from feabas_tpu_torch.ops import match_loop
    from feabas_tpu_torch.stitcher import Stitcher

    t0 = time.perf_counter()
    world, tiles, true_bb, stage_bb = make_grid(dev)
    root = tempfile.mkdtemp(prefix='feabas_chip_smoke_')
    # observe, without changing them: the systems the path binds the CG
    # operator to, and the inputs and result of the first per-round match
    # solve and of the first fused ENG solve of stitch optimization
    ops = OperatorSpy().__enter__()
    rounds = FirstCall(match_loop, '_solve_round').__enter__()
    eng = FirstCall(optimizer, '_linear_solve_eng').__enter__()
    fem_by_stage = {}

    def before(mode):
        fem_by_stage[ops.stage] = device_mod.launch_counts()['fem_operator']
        ops.stage = mode
        eng.armed = mode == 'optimization'

    try:
        wd = setup_workdir(root, tiles, stage_bb)
        log(f'[slice] grid {ROWS}x{COLS} of {TILE_H}x{TILE_W} uint8 tiles, '
            f'world {world.shape}, set-up {time.perf_counter() - t0:.2f} s')
        torch.cuda.reset_peak_memory_stats()
        device_mod.reset_launch_counts()
        stage_s = stitch_stages(profile, before)
        before('')
        launches = device_mod.launch_counts()
        by_shape = device_mod.launch_counts_by_shape()
        for x in (ops, rounds, eng):
            x.__exit__()
        fem_match = fem_by_stage['matching']
        fem_opt = fem_by_stage['optimization'] - fem_match
        peak = torch.cuda.max_memory_allocated()
        log('[slice] stage seconds ' + json.dumps(
            {k: round(v, 3) for k, v in stage_s.items()})
            + f'; max_memory_allocated {peak} B; launches {launches}')

        st = Stitcher.from_h5(os.path.join(wd, 'stitch', 'match_h5',
                                           's0001.h5'))
        overlaps = [tuple(p) for p in st.find_overlaps(min_overlap_width=25)]
        if sorted(st.matches) != sorted(overlaps) or len(overlaps) < 7:
            raise RuntimeError(f'matched {sorted(st.matches)} of overlaps '
                               f'{sorted(overlaps)}')
        worst = 0.0
        for (i, j), m in st.matches.items():
            err = (m.xy0 + true_bb[i][:2]) - (m.xy1 + true_bb[j][:2])
            worst = max(worst, float(np.median(np.abs(err), axis=0).max()))
        if not worst < 0.5:
            raise RuntimeError(f'median match error {worst} px >= 0.5')
        st2 = Stitcher.from_h5(os.path.join(wd, 'stitch', 'tform', 's0001.h5'))
        so = [m.vertices_w_offset('MOVING').mean(axis=0)
              - m.vertices_w_offset('INITIAL').mean(axis=0) for m in st2.meshes]
        place = max(float(np.abs((so[j] - so[0])
                                 - (true_bb[j][:2] - true_bb[0][:2])).max())
                    for j in range(1, len(so)))
        if not place < 0.5:
            raise RuntimeError(f'placement error {place} px >= 0.5')
        # a central world patch must reappear at the solved position
        # (section corner normalized to (1, 1)); search +-16 px around it
        ps, slack = min(1024, world.shape[0] // 2, world.shape[1] // 2), 16
        py, px = (world.shape[0] - ps) // 2, (world.shape[1] - ps) // 2
        ey = py - true_bb[:, 1].min() + 1
        ex = px - true_bb[:, 0].min() + 1
        out_dir = os.path.join(wd, 'stitched_sections', 'mip0', 's0001')
        win = read_rendered(
            out_dir,
            (int(ex - slack), int(ey - slack), int(ex + ps + slack),
             int(ey + ps + slack)))
        res = cv2.matchTemplate(win.astype(np.float32),
                                world[py:py + ps, px:px + ps].astype(np.float32),
                                cv2.TM_CCOEFF_NORMED)
        cc = float(res.max())
        if not cc > 0.9:
            raise RuntimeError(f'render cc {cc} <= 0.9')
        for name in ('dog_filter', 'gaussian_blur', 'montage_blend'):
            if launches[name] <= 0:
                raise RuntimeError(f'{name} was not launched by the slice')
        if fem_match <= 0 or fem_opt <= 0:
            raise RuntimeError(f'fem_operator launched {fem_match} times in '
                               f'matching and {fem_opt} in optimization')
        log(f'[slice] fem_operator launches: matching {fem_match}, '
            f'optimization {fem_opt}')
        blocks = len([f for f in os.listdir(out_dir) if f.endswith('.png')])
        if launches['montage_blend'] < blocks:
            raise RuntimeError(f'{launches["montage_blend"]} montage_blend '
                               f'launches for {blocks} output blocks')
        log(f'[slice] montage_blend launches by (C, K, R): '
            f'{by_shape["montage_blend"]} for {blocks} output blocks')
        if any(m == 'jax' or m.startswith('jax.') for m in sys.modules):
            raise RuntimeError('jax was imported')
        log(f'[slice] {len(st.matches)} matches (all overlaps), worst median '
            f'match error {worst:.4f} px, worst placement error {place:.4f} '
            f'px, render cc {cc:.5f}')
        # after the counts were read: these launches compare, not count
        rows = montage_path_rows(dev, wd, by_shape['montage_blend'])
        transfer_and_roi_checks(wd, true_bb)
        rows += fem_path_rows(dev, ops.systems, by_shape['fem_operator'],
                              'phase-4', FEM_TIMED)
        for spy, solve in ((rounds, match_loop._solve_round),
                           (eng, optimizer._linear_solve_eng)):
            if spy.args is None:
                raise RuntimeError(f'the stitch path made no {spy.name} call')
            a, k = spy.args
            # (NV, NT, L) of the system the solve bound the operator to
            shape = ((a[0].shape[0] * a[0].shape[1], a[2].shape[0],
                      a[6].shape[0] * a[6].shape[1])
                     if spy.name == '_solve_round' else
                     (a[11].shape[0], a[1].shape[0], a[10].shape[0]))
            determinism_check(spy.name, shape, lambda: solve(*a, **k),
                              spy.result)
        if keep is not None:
            keep['stitch'] = (root, wd)
        return launches, by_shape, stage_s, rows
    finally:
        for x in (ops, rounds, eng):
            x.__exit__()
        if keep is None or 'stitch' not in keep:
            shutil.rmtree(root, ignore_errors=True)


LUT_SEED = SEED + 11


def seeded_lut(mr):
    """A seeded INTERP1D LUT of one non-identity line for each tile of
    ``mr`` (gain 0.8-1.2, offset -12-12 at control points 0, 128, 255)."""
    import numpy as np
    rng = np.random.default_rng(LUT_SEED)
    xp = [0.0, 128.0, 255.0]
    lut = {'__TYPE__': 'INTERP1D'}
    for p in mr.loader.imgpaths:
        g, o = rng.uniform(0.8, 1.2), rng.uniform(-12.0, 12.0)
        lut[os.path.basename(p)] = [xp, [g * x + o for x in xp]]
    return lut


def transfer_and_roi_checks(wd, true_bb):
    """Phase 4's checks of the ``MontageRenderer`` API on the stitch work
    dir: the block at (1, 1) blended once more after
    ``add_transfer_functions`` with ``seeded_lut``, the montage blend held
    bit-equal to its plain version there (and its output changed by the
    transfers); ``generate_roi_mask`` at scale 1/16 within 1 px of the
    union of the tiles' placed rectangles."""
    import numpy as np
    import scipy.ndimage as ndi
    from feabas_tpu_torch import config
    from feabas_tpu_torch.ops import montage_render as mrd
    from feabas_tpu_torch.stitcher import MontageRenderer
    plain = next(b for b in stitch_blocks(wd) if tuple(b[1][:2]) == (1, 1))
    tuned = next(b for b in stitch_blocks(wd, lut=seeded_lut)
                 if tuple(b[1][:2]) == (1, 1))
    aux = tuned[3][4]
    if not (aux[:, 3] != 1).all() or not (aux[:, 4] != 0).all():
        raise RuntimeError(f'the LUT did not reach the blend: aux {aux}')
    out = montage_compare({'args': tuned[3], 'covered': True})
    if mrd.montage_blend(*plain[3])[0].equal(out[0]):
        raise RuntimeError('the transfers left the block unchanged')
    rconf = config.stitch_configs().get('rendering', {})
    mr = MontageRenderer.from_h5(
        os.path.join(wd, 'stitch', 'tform', 's0001.h5'),
        loader_config=rconf.get('loader_settings') or {})
    scale = 1.0 / 16
    mask = mr.generate_roi_mask(scale=scale) > 0
    # pixel (r, c) sits at (floor(x0 * scale) + c, floor(y0 * scale) + r)
    x0, y0 = np.floor(np.asarray(mr.bounds[:2]) * scale)
    rects = np.zeros(mask.shape, bool)
    yy, xx = np.mgrid[:mask.shape[0], :mask.shape[1]]
    for m in mr.meshes:
        bx0, by0, bx1, by1 = (np.asarray(m.bbox(gear='MOVING')) * scale
                              - [x0, y0, x0, y0])
        rects |= (xx >= bx0) & (xx < bx1) & (yy >= by0) & (yy < by1)
    inner = ndi.binary_erosion(rects, iterations=1, border_value=1)
    outer = ndi.binary_dilation(rects, iterations=1)
    if not ((mask >= inner) & (mask <= outer)).all():
        raise RuntimeError('generate_roi_mask at 1/16 is off the tiles\' '
                           f'union by more than 1 px: {int((mask != rects).sum())} '
                           f'of {mask.size} px differ')
    log(f'[slice] block at (1, 1) under seeded transfers (gain '
        f'{aux[:, 3].min():.3f}-{aux[:, 3].max():.3f}): montage_blend '
        f'bit-equal to plain; ROI mask {mask.shape} at 1/16 within 1 px of '
        f'the union of {len(mr.meshes)} tile rectangles ({int(mask.sum())} '
        f'px, {int((mask != rects).sum())} on the edge)')


# phase 5: the serial-section stack
STACK_S = 8
SECTION = 8192                        # px per side at 4 nm
SECTION_MARGIN = 256
SECTION_TILE = 4096
DRIFT_STD = 24.0                      # px per section step
# smooth warp of z * 2 px, period 2048 px: the default window solve
# (stiffness_lambda 1, trace-balanced) leaves ~60% of a 2.5%-strain warp
# per section step unresolved, in the JAX package as in the port, so at
# z * 8 px sections 3-7 no longer overlay section 0
WARP_AMP, WARP_PERIOD = 2.0, 2048.0
ALIGN_SCALE = 4                       # working mip 2: 16 nm px


def _section_disp(z, drift, x, y, xp):
    """Displacement d_z at mip0 pixel (x, y) of section z: its cumulative
    drift plus z times the smooth warp (x, y arrays of module xp)."""
    w = 2 * math.pi / WARP_PERIOD
    return (drift[z][0] + z * WARP_AMP * xp.sin(w * y),
            drift[z][1] + z * WARP_AMP * xp.cos(w * x))


def make_stack(dev, n=STACK_S):
    """``n`` sections on the card: section z at mip0 pixel p shows the
    seeded base texture at p + margin + d_z(p) (the first sections of any
    ``n`` are the same). Returns (sections as host uint8 arrays, drift
    (n, 2))."""
    import numpy as np
    import torch
    from feabas_tpu_torch.ops.warp import bilinear_sample
    rng = np.random.default_rng(SEED)
    steps = rng.normal(0, DRIFT_STD, (n, 2))
    steps[0] = 0.0
    drift = np.cumsum(steps, axis=0)
    reach = np.abs(drift).max() + (n - 1) * WARP_AMP
    if not reach < SECTION_MARGIN - 2:
        raise RuntimeError(f'drift reach {reach} px exceeds the margin')
    side = SECTION + 2 * SECTION_MARGIN
    # sigma 16 px at mip0: 4 px at the working resolution, where the
    # section matcher's DoG (sigma 3.5) looks
    base = make_texture(dev, side, side, seed=SEED + 1,
                        blur=4.0 * ALIGN_SCALE).to(torch.float32)
    gy, gx = torch.meshgrid(
        torch.arange(SECTION, dtype=torch.float32, device=dev),
        torch.arange(SECTION, dtype=torch.float32, device=dev), indexing='ij')
    sections = []
    for z in range(n):
        dx, dy = _section_disp(z, drift, gx, gy, torch)
        img = bilinear_sample(base, gx + SECTION_MARGIN + dx,
                              gy + SECTION_MARGIN + dy)
        sections.append(torch.round(img).clamp(0, 255).to(torch.uint8)
                        .cpu().numpy())
    return sections, drift


def setup_align_workdir(root, sections):
    """Config dir + work dir holding the stack as stitched sections (2x2
    tiles of 4096^2 each, uncompressed PNG) and the alignment overrides;
    points the config system at it."""
    import cv2
    from concurrent.futures import ThreadPoolExecutor
    cfg = os.path.join(root, 'configs')
    shutil.copytree(os.path.join(REPO, 'configs'), cfg)
    wd = os.path.join(root, 'work_dir')
    _save_yaml(os.path.join(cfg, 'general_configs.yaml'), {
        'working_directory': wd, 'parallel_framework': 'serial',
        'full_resolution': 4, 'section_thickness': 30,
        'logfile_level': 'NONE', 'archive_level': 'NONE',
        'console_level': 'WARNING', 'device': {'render': 'auto'}})
    names = [f's{z:04d}' for z in range(len(sections))]
    jobs = []
    for name, img in zip(names, sections):
        d = os.path.join(wd, 'stitched_sections', 'mip0', name)
        os.makedirs(d)
        lines = ['{ROOT_DIR}\t' + d, '{RESOLUTION}\t4']
        for r in range(0, SECTION, SECTION_TILE):
            for c in range(0, SECTION, SECTION_TILE):
                fn = f'{name}_tr{r // SECTION_TILE + 1}-tc{c // SECTION_TILE + 1}.png'
                jobs.append((os.path.join(d, fn),
                             img[r:r + SECTION_TILE, c:c + SECTION_TILE]))
                lines.append(f'{fn}\t{c}\t{r}\t{c + SECTION_TILE}\t'
                             f'{r + SECTION_TILE}')
        with open(os.path.join(d, 'metadata.txt'), 'w') as f:
            f.write('\n'.join(lines) + '\n')

    def write(job):
        if not cv2.imwrite(job[0], job[1], [cv2.IMWRITE_PNG_COMPRESSION, 0]):
            raise OSError(f'could not write {job[0]}')

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    _save_yaml(os.path.join(wd, 'configs', 'alignment_configs.yaml'), {
        'matching': {'working_mip_level': 2,
                     'loader_config': {'apply_CLAHE': False}},
        'rendering': {'remap_interp': 'LINEAR', 'device_render': True,
                      'loader_config': {'apply_CLAHE': False}}})
    os.environ['FEABAS_TPU_CONFIG_DIR'] = cfg
    from feabas_tpu_torch import config
    config.clear_config_caches()
    return wd, names


class shipped_rendering:
    """Within: the align work dir's rendering at the shipped
    ``remap_interp: LANCZOS`` and ``device_render: null``, into
    ``out_dir``; the overrides ``setup_align_workdir`` wrote are put back
    after."""

    def __init__(self, wd, out_dir):
        self.path = os.path.join(wd, 'configs', 'alignment_configs.yaml')
        self.out_dir = out_dir

    def __enter__(self):
        import yaml
        from feabas_tpu_torch import config
        with open(self.path) as f:
            self.saved = f.read()
        over = yaml.safe_load(self.saved)
        over['rendering'].update(remap_interp='LANCZOS', device_render=None,
                                 out_dir=self.out_dir)
        _save_yaml(self.path, over)
        config.clear_config_caches()
        return self

    def __exit__(self, *exc):
        from feabas_tpu_torch import config
        with open(self.path, 'w') as f:
            f.write(self.saved)
        config.clear_config_caches()


def _match_truth_error(match, z0, z1, drift):
    """|xy0 - truth| (working px) of matches between sections z0 and z1: the
    content at mip0 p1 of z1 sits where p0 + d_z0(p0) = p1 + d_z1(p1)."""
    import numpy as np
    p1 = match.xy1 * ALIGN_SCALE + (ALIGN_SCALE - 1) / 2
    dx1, dy1 = _section_disp(z1, drift, p1[:, 0], p1[:, 1], np)
    target = p1 + np.stack([dx1, dy1], -1)
    p0 = target.copy()
    for _ in range(8):
        dx0, dy0 = _section_disp(z0, drift, p0[:, 0], p0[:, 1], np)
        p0 = target - np.stack([dx0, dy0], -1)
    xy0 = (p0 - (ALIGN_SCALE - 1) / 2) / ALIGN_SCALE
    return np.linalg.norm(match.xy0 - xy0, axis=-1)


def align_pair_checks(wd, names, drift):
    """Matches per neighbouring pair and their median error against the
    analytic truth; fails below 50 matches or at a median of 1 px or
    more. Returns (counts, median errors)."""
    import numpy as np
    from feabas_tpu_torch import aligner
    errs, counts = [], []
    for z in range(1, len(names)):
        m = aligner.read_matches_from_h5(os.path.join(
            wd, 'align', 'matches', aligner.match_name(names[z - 1],
                                                      names[z])))
        counts.append(m.xy0.shape[0])
        errs.append(float(np.median(_match_truth_error(m, z - 1, z, drift))))
    if min(counts) < 50:
        raise RuntimeError(f'matches per pair {counts}: fewer than 50')
    if not max(errs) < 1.0:
        raise RuntimeError(f'median match errors {errs} px: one >= 1')
    return counts, errs


def align_windows(wd, names, out_root=None):
    """Each rendered section's 2048^2 window at the canvas center, read
    from the render under ``out_root`` (the work dir's aligned_stack by
    default)."""
    import numpy as np
    from feabas_tpu_torch.dal import StaticImageLoader
    with open(os.path.join(wd, 'align', 'tform', 'canvas.json')) as f:
        canvas = json.load(f)['mip0']
    cx, cy = (canvas[0] + canvas[2]) // 2, (canvas[1] + canvas[3]) // 2
    win = (cx - 1024, cy - 1024, cx + 1024, cy + 1024)
    out = os.path.join(out_root or os.path.join(wd, 'aligned_stack'), 'mip0')
    return [StaticImageLoader.from_coordinate_file(os.path.join(
        out, f'{z:05d}_{n}', 'metadata.txt')).crop(win).astype(np.float64)
        for z, n in enumerate(names)]


def _cc(a, b):
    import numpy as np
    ok = (a > 0) & (b > 0)
    return float(np.corrcoef(a[ok], b[ok])[0, 1])


def align_overlay_ccs(wd, names, out_root=None):
    """cc of each rendered section against section 0 on a 2048^2 window at
    the canvas center, over the pixels both cover."""
    rendered = align_windows(wd, names, out_root)
    return [_cc(rendered[0], img) for img in rendered[1:]]


def run_align(dev, chunked=False, keep=None):
    """Phase 5: the serial-section stack at full size through the align
    CLI (meshing, matching, optimization, rendering); with ``chunked``
    phase 8 (``run_chunked``) follows on its work dir. Returns (launches,
    launches by shape, stage seconds, the CG operator's rows, phase 8's
    result or None). With ``keep`` (a dict) its work dir stays for phase
    9, as ``keep['align']`` = (root, work dir, section names)."""
    import numpy as np
    import torch
    from feabas_tpu_torch import aligner, state
    from feabas_tpu_torch import device as device_mod
    from feabas_tpu_torch.ops import render
    from feabas_tpu_torch.parallel import window
    from feabas_tpu_torch.scripts import align_main

    t0 = time.perf_counter()
    sections, drift = make_stack(dev)
    root = tempfile.mkdtemp(prefix='feabas_chip_align_')
    # observe, without changing them, the window solves and the raster
    # batches of the run: CUDA events around each raster call, the host
    # clock around each batch upload
    stacked, raster_blocks, device_blocks = [], [0], [0]
    raster_events, upload_s = [], [0.0]
    solve, raster, engine_render, upload = (
        aligner.Stack._sharded_window_solve, render.raster_blocks,
        render.DeviceRenderEngine.render_blocks, state.render_batch_to_device)

    def solve_spy(self, *a, **k):
        stacked.append(solve(self, *a, **k) and self.last_window_sharded)
        return stacked[-1]

    def raster_spy(src, tables, *a, **k):
        raster_blocks[0] += tables.shape[0]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = raster(src, tables, *a, **k)
        ev[1].record()
        raster_events.append(ev)
        return out

    def upload_spy(*a, **k):
        t = time.perf_counter()
        out = upload(*a, **k)
        upload_s[0] += time.perf_counter() - t
        return out

    def render_spy(self, *a, **k):
        out = engine_render(self, *a, **k)
        device_blocks[0] += sum(r is not None for r in out)
        return out

    aligner.Stack._sharded_window_solve = solve_spy
    render.raster_blocks = raster_spy
    render.DeviceRenderEngine.render_blocks = render_spy
    state.render_batch_to_device = upload_spy
    # the systems the path binds the CG operator to, and the inputs and
    # result of its first stacked window solve
    ops = OperatorSpy().__enter__()
    stacks = FirstCall(window, 'stack_solve').__enter__()
    try:
        wd, names = setup_align_workdir(root, sections)
        log(f'[align] {STACK_S} sections of {SECTION}x{SECTION} uint8, drift '
            f'reach {np.abs(drift).max():.1f} px, set-up '
            f'{time.perf_counter() - t0:.2f} s')
        torch.cuda.reset_peak_memory_stats()
        device_mod.reset_launch_counts()
        stage_s, fem_by_stage = {}, {}
        for mode in ('meshing', 'matching', 'optimization', 'rendering'):
            ops.stage = mode
            t = time.perf_counter()
            align_main.main(['--mode', mode])
            torch.cuda.synchronize()
            stage_s[mode] = time.perf_counter() - t
            fem_by_stage[mode] = device_mod.launch_counts()['fem_operator']
        # the shipped rendering settings, into a second out dir
        lanczos_root = os.path.join(wd, 'aligned_stack_lanczos')
        with shipped_rendering(wd, lanczos_root):
            t = time.perf_counter()
            align_main.main(['--mode', 'rendering'])
            torch.cuda.synchronize()
            stage_s['rendering_lanczos'] = time.perf_counter() - t
        launches = device_mod.launch_counts()
        by_shape = device_mod.launch_counts_by_shape()
        ops.__exit__()
        stacks.__exit__()
        peak = torch.cuda.max_memory_allocated()
        log('[align] stage seconds ' + json.dumps(
            {k: round(v, 3) for k, v in stage_s.items()})
            + f'; max_memory_allocated {peak} B; launches {launches}')
        counts, errs = align_pair_checks(wd, names, drift)
        worst = max(errs)
        if not (stacked and all(stacked)):
            raise RuntimeError(f'window solves {stacked}: not all stacked')
        for n in names:
            if not os.path.exists(os.path.join(wd, 'align', 'tform', n + '.h5')):
                raise RuntimeError(f'no tform for {n}')
        if not os.path.exists(os.path.join(wd, 'align', 'residues.csv')):
            raise RuntimeError('no residues.csv')
        ccs = align_overlay_ccs(wd, names)
        if not min(ccs) > 0.85:
            raise RuntimeError(f'rendered overlay cc {ccs}, median match '
                               f'errors {errs}')
        for name in ('dog_filter', 'mesh_raster', 'mesh_raster_lanczos4',
                     'fem_operator'):
            if launches[name] <= 0:
                raise RuntimeError(f'{name} was not launched by the align path')
        lanczos_ccs = align_overlay_ccs(wd, names, lanczos_root)
        lanczos_vs_linear = [_cc(a, b) for a, b in zip(
            align_windows(wd, names), align_windows(wd, names, lanczos_root))]
        if not (min(lanczos_ccs) > 0.85 and min(lanczos_vs_linear) > 0.95):
            raise RuntimeError(f'LANCZOS render: overlay cc {lanczos_ccs}, '
                               f'cc against LINEAR {lanczos_vs_linear}')
        log(f'[align] LANCZOS render (shipped settings): '
            f'{launches["mesh_raster_lanczos4"]} Lanczos-4 raster launches, '
            f'overlay cc {min(lanczos_ccs):.5f}-{max(lanczos_ccs):.5f}, cc '
            f'against the LINEAR render {min(lanczos_vs_linear):.5f}-'
            f'{max(lanczos_vs_linear):.5f}')
        log(f'[align] fem_operator launches by stage (cumulative) '
            f'{fem_by_stage}')
        if raster_blocks[0] < device_blocks[0] or device_blocks[0] == 0:
            raise RuntimeError(f'{raster_blocks[0]} blocks rasterized by the '
                               f'kernel for {device_blocks[0]} device blocks')
        if any(m == 'jax' or m.startswith('jax.') for m in sys.modules):
            raise RuntimeError('jax was imported')
        log(f'[align] {len(counts)} pairs matched ({min(counts)}-{max(counts)} '
            f'matches), worst median match error {worst:.4f} px, '
            f'{len(stacked)} stacked window solve(s), {device_blocks[0]} '
            f'device blocks in {launches["mesh_raster"]} raster launches, '
            f'overlay cc {min(ccs):.5f}-{max(ccs):.5f}')
        raster_ms = sum(a.elapsed_time(b) for a, b in raster_events)
        log(f'[align] rendering: {raster_ms:.3f} ms between the CUDA events '
            f'around the {len(raster_events)} raster calls (the kernel and, '
            f'on an idle card, the wait for its launch), {upload_s[0]:.3f} s '
            f'of host time in the {len(raster_events)} batch uploads')
        # after the counts were read: these launches compare, not count
        rows = fem_path_rows(dev, ops.systems, by_shape['fem_operator'],
                             'phase-5', FEM_TIMED)
        if stacks.args is None:
            raise RuntimeError('the align path made no stack_solve call')
        a, k = stacks.args
        determinism_check('stack_solve', a[1].shape[:2],
                          lambda: window.stack_solve(*a, **k), stacks.result)
        relax_check(dev, wd, names[STACK_S // 2])
        aligner.Stack._sharded_window_solve = solve
        result8 = run_chunked(dev, root, wd, names) if chunked else None
        if keep is not None:
            keep['align'] = (root, wd, names)
        return launches, by_shape, stage_s, rows, result8
    finally:
        aligner.Stack._sharded_window_solve = solve
        render.raster_blocks = raster
        render.DeviceRenderEngine.render_blocks = engine_render
        state.render_batch_to_device = upload
        ops.__exit__()
        stacks.__exit__()
        if keep is None or 'align' not in keep:
            shutil.rmtree(root, ignore_errors=True)


def relax_check(dev, wd, name):
    """``relax_mesh`` on what align meshing gives it where a section has a
    thumbnail tform: the section's phase-5 mesh carried through a tform
    (here its phase-5 tform), relaxing the vertices of its most deformed
    tenth of triangles; three calls from one placement, bit-equal."""
    import numpy as np
    from feabas_tpu_torch import optimizer
    from feabas_tpu_torch.mesh import Mesh, transform_mesh
    mesh = Mesh.from_h5(os.path.join(wd, 'align', 'mesh', name + '.h5'))
    carrier = Mesh.from_h5(os.path.join(wd, 'align', 'tform', name + '.h5'))
    carrier.change_resolution(mesh.resolution)
    moved = transform_mesh(mesh, carrier)
    d = moved.svds_to_deform(gear1='MOVING')
    free = np.zeros(moved.num_vertices, bool)
    free[np.unique(moved.triangles[d >= np.quantile(d, 0.9)])] = True

    def run():
        m = moved.copy()
        optimizer.relax_mesh(m, free_vertices=free, device=dev)
        return m.vertices_w_offset('MOVING')

    first = run()
    if not np.isfinite(first).all():
        raise RuntimeError(f'relax_mesh on {name}: non-finite vertices')
    determinism_check('relax_mesh', (moved.num_vertices,
                                     moved.num_triangles), run, first)


# phase 8: chunked alignment over phase 5's stack
CHUNK_SETTINGS = {'chunked_to_depth': 2, 'default_chunk_size': 2,
                  'junction_width': 0.2, 'pad_junctional': True}


def chunked_workdir(root, wd, tag):
    """A work dir holding phase 5's meshes, matches and overrides (no
    tform), with CHUNK_SETTINGS added to its alignment overrides, and a
    config dir naming it; points the config system at it. Returns it."""
    from feabas_tpu_torch import config, storage
    cfg = os.path.join(root, 'configs_' + tag)
    shutil.copytree(os.path.join(root, 'configs'), cfg)
    out = os.path.join(root, 'work_dir_' + tag)
    for sub in ('align/mesh', 'align/matches', 'configs'):
        shutil.copytree(os.path.join(wd, sub), os.path.join(out, sub))
    general = os.path.join(cfg, 'general_configs.yaml')
    _save_yaml(general, dict(storage.load_yaml(general),
                             working_directory=out))
    over = os.path.join(out, 'configs', 'alignment_configs.yaml')
    conf = storage.load_yaml(over)
    conf.setdefault('optimization', {})['chunk_settings'] = dict(
        CHUNK_SETTINGS)
    _save_yaml(over, conf)
    os.environ['FEABAS_TPU_CONFIG_DIR'] = cfg
    config.clear_config_caches()
    return out


def pair_residues(wd, tform_dir, names):
    """Median residue (px) of each neighbouring pair's matches at the tforms
    in ``tform_dir``."""
    import numpy as np
    from feabas_tpu_torch import aligner
    from feabas_tpu_torch.optimizer import Link
    stack = aligner.Stack(section_list=names,
                          mesh_dir=os.path.join(wd, 'align', 'mesh'),
                          tform_dir=tform_dir,
                          match_dir=os.path.join(wd, 'align', 'matches'))
    meds = []
    for pair in stack.match_list:
        mt = stack.get_match(pair)
        link = Link.from_coordinates(stack.get_mesh(pair[0]),
                                     stack.get_mesh(pair[1]), mt.xy0, mt.xy1,
                                     weight=mt.weight)
        meds.append(float(np.median(link.residues(gear='MOVING'))))
    return np.asarray(meds)


def run_chunked(dev, root, wd, names):
    """Phase 8: the optimization stage of the align CLI with CHUNK_SETTINGS
    (depth 2, chunks of 2: 4 chunks -> 4 metas -> 2 chunks -> 2 metas -> a
    window) over phase 5's meshes and matches on a copy of its work dir;
    then the same command again on that tform dir (a resume: no window
    solve, every tform's bytes kept), then once more into a fresh copy
    (bit-equal tforms). Checks every tform, every chunk committed, no
    flipped triangle, and the residue rule of tests/test_aligner.py against
    phase 5's windowed tforms. Returns (launches, launches by shape, stage
    seconds, no rows)."""
    import glob
    import numpy as np
    import torch
    from feabas_tpu_torch import aligner
    from feabas_tpu_torch import device as device_mod
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.scripts import align_main
    solves = [0, 0]
    stacked, window = (aligner.Stack._sharded_window_solve,
                       aligner.Stack.optimize_section_list)

    def stacked_spy(self, *a, **k):
        solves[0] += 1
        return stacked(self, *a, **k)

    def window_spy(self, *a, **k):
        solves[1] += 1
        return window(self, *a, **k)

    def optimization(wd8):
        solves[:] = [0, 0]
        t = time.perf_counter()
        align_main.main(['--mode', 'optimization'])
        torch.cuda.synchronize()
        return time.perf_counter() - t, tuple(solves)

    def tforms(wd8):
        out = {}
        for n in names:
            path = os.path.join(wd8, 'align', 'tform', n + '.h5')
            if not os.path.exists(path):
                raise RuntimeError(f'phase 8: no tform for {n}')
            with open(path, 'rb') as f:
                out[n] = (f.read(), Mesh.from_h5(path))
        return out

    aligner.Stack._sharded_window_solve = stacked_spy
    aligner.Stack.optimize_section_list = window_spy
    try:
        wd8 = chunked_workdir(root, wd, 'chunked')
        torch.cuda.reset_peak_memory_stats()
        device_mod.reset_launch_counts()
        stage_s, first = {}, {}
        stage_s['first'], first['solves'] = optimization(wd8)
        launches = device_mod.launch_counts()
        by_shape = device_mod.launch_counts_by_shape()
        peak = torch.cuda.max_memory_allocated()
        got = tforms(wd8)
        maps = sorted(glob.glob(os.path.join(wd8, 'align', 'chunked_tform',
                                             '**', 'chunk_map.json'),
                                recursive=True))
        chunks = []
        for path in maps:
            with open(path) as f:
                chunks.append(json.load(f)['chunks'])
        if (len(maps) != CHUNK_SETTINGS['chunked_to_depth']
                or not all(c['committed'] for m in chunks for c in m)):
            raise RuntimeError(f'phase 8: chunk maps {maps}: {chunks}')
        flips = {n: int(m.flipped_triangles('MOVING').size)
                 for n, (_, m) in got.items()}
        if any(flips.values()):
            raise RuntimeError(f'phase 8: flipped triangles {flips}')
        r_c = pair_residues(wd8, os.path.join(wd8, 'align', 'tform'), names)
        r_w = pair_residues(wd, os.path.join(wd, 'align', 'tform'), names)
        if not (len(r_c) == len(names) - 1
                and r_c.max() < max(2.5 * r_w.max(), 1.0)
                and np.median(r_c) < max(3 * np.median(r_w), 0.5)):
            raise RuntimeError(f'phase 8: pair residues {r_c} px against '
                               f'the windowed {r_w} px')
        stage_s['resume'], resumed = optimization(wd8)
        if resumed != (0, 0):
            raise RuntimeError(f'phase 8: the resume made {resumed} '
                               '(stacked, window) solves')
        if any(b != got[n][0] for n, (b, _) in tforms(wd8).items()):
            raise RuntimeError('phase 8: the resume rewrote a tform')
        wd8b = chunked_workdir(root, wd, 'chunked_again')
        stage_s['again'], _ = optimization(wd8b)
        again = tforms(wd8b)
        for n, (_, m) in got.items():
            for gear in ('MOVING', 'FIXED'):
                if not np.array_equal(m.vertices_w_offset(gear),
                                      again[n][1].vertices_w_offset(gear)):
                    raise RuntimeError(f'phase 8: {n} differs between two '
                                       f'runs ({gear} gear)')
        log('[chunked] stage seconds ' + json.dumps(
            {k: round(v, 3) for k, v in stage_s.items()})
            + f'; max_memory_allocated {peak} B; launches {launches}')
        log(f'[chunked] {len(names)} sections, {CHUNK_SETTINGS}: '
            f'{first["solves"][1]} window solves ({first["solves"][0]} '
            f'stacked) in the first run, none in the resume; chunk maps '
            f'{[len(m) for m in chunks]} chunks, all committed; no flipped '
            f'triangle; pair residue medians max {r_c.max():.4f} / median '
            f'{np.median(r_c):.4f} px against the windowed {r_w.max():.4f} '
            f'/ {np.median(r_w):.4f}; the resume kept every tform\'s bytes '
            'and a fresh run gave the same tforms bit for bit')
        return launches, by_shape, stage_s, []
    finally:
        aligner.Stack._sharded_window_solve = stacked
        aligner.Stack.optimize_section_list = window


# --------------- phase 3 and 7: the general CG operator (K5/K6) --------------- #

FEM_RTOL = 1e-5         # f32 sums in another order: of max|y|
FEM_LIBRARY_RTOL = 1e-4  # the library's CSR product sums otherwise again
FEM_TURNS = 5           # timed turns of the kernel and the library call


def fem_bound(nv, nt, nl, sides):
    """The operator's least time over ``nl`` links that weigh and ``sides``
    link sides that the function reads (two a link, one an anchor's: a
    side that weighs nothing and a link weighed 0 in every solve are not
    read): what it needs, each once (f32 data, int32 indices): Ke, tris, a
    side's 3 indices and 3 barycentrics, a link's weight, free, x and y;
    26 FLOP an element corner (two rows of 6 FMAs and their sums), 12 a
    side and 6 a link for the weighted residual once, 4 a side's point, 8
    a vertex. The kernel's own CSR tables are its design's cost, not the
    function's, and are not counted."""
    nbytes = 4 * (nt * 36 + nt * 3 + 6 * sides + nl + nv + 2 * nv + 2 * nv)
    flop = nt * 3 * 26 + sides * 12 + nl * 6 + 3 * sides * 4 + nv * 8
    return bound(flop, nbytes)


def listed_links(tables):
    """(links, sides) that ``tables`` list: the links that have an entry
    and the link sides, one for every three entries."""
    import torch
    ent = tables['lnk_ent'][:int(tables['lnk_ptr'][-1])].long()
    return int(torch.unique(ent // 6).numel()), int(ent.numel()) // 3


def operator_csr(Ke, tables, weight, free, lam_s, lam_c):
    """free * (lam_s K + lam_c C^T W^2 C) assembled as one (2 NV, 2 NV)
    CSR matrix on the card (DOF 2 v + c), for ``torch.sparse.mm``."""
    import torch
    t, nv = tables, tables['nv']
    tris = t['tris'].long()
    dof = torch.stack([2 * tris, 2 * tris + 1], -1).reshape(-1, 6)
    rows = [dof[:, :, None].expand(-1, 6, 6).reshape(-1)]
    cols = [dof[:, None, :].expand(-1, 6, 6).reshape(-1)]
    vals = [(Ke * lam_s).reshape(-1)]
    vid = torch.cat([t['idx1'], t['idx0']], 1).long()
    coef = torch.cat([t['bary1'], -t['bary0']], 1)
    cc = (coef[:, :, None] * coef[:, None, :]
          * (weight ** 2 * lam_c)[:, None, None]).reshape(-1)
    for c in (0, 1):
        d = 2 * vid + c
        rows.append(d[:, :, None].expand(-1, 6, 6).reshape(-1))
        cols.append(d[:, None, :].expand(-1, 6, 6).reshape(-1))
        vals.append(cc)
    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    vals = vals * free.reshape(-1).repeat_interleave(2)[rows]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', UserWarning)   # CSR is 'beta'
        return torch.sparse_coo_tensor(
            torch.stack([rows, cols]), vals, (2 * nv, 2 * nv),
            check_invariants=False).coalesce().to_sparse_csr()


def fem_row(name, x, Ke, tables, weight, free, lam_s, lam_c):
    """The kernel against ``elastic_operator_plain`` on the card, at each G
    (lanes a vertex): within FEM_RTOL of max|y|, bit-equal to itself
    across two launches, device us (CUDA-graph replay). At the G the
    tables chose: call ms of the bound operator, as the general path calls
    it, and of one ``torch.sparse.mm`` of the assembled matrix (assembled
    outside the timed window), each the median of FEM_TURNS turns (CUDA
    events); the kernel's registers, spills and resident blocks a SM; the
    plain version's ms."""
    import numpy as np
    import torch
    from feabas_tpu_torch.ops import fem
    want = fem.elastic_operator_plain(x, Ke, tables, weight, free, lam_s,
                                      lam_c)
    scale = float(want.abs().max())
    errs, form_us = [], {}
    for g in fem.OPERATOR_GROUPS:
        form = f'G{g}'
        op = fem.bind_elastic_operator(Ke, dict(tables, group=g), weight,
                                       free, lam_s, lam_c)
        got, again = op(x), op(x)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise RuntimeError(f'fem_operator {name}, {form}: two launches '
                               'differ')
        errs.append(float((got - want).abs().max()))
        if not errs[-1] <= FEM_RTOL * scale:
            raise RuntimeError(f'fem_operator {name}, {form}: max_abs_err '
                               f'{errs[-1]} > {FEM_RTOL} x {scale}')
        form_us[form] = graph_time(lambda: op(x))
    pms = cuda_time(lambda: fem.elastic_operator_plain(
        x, Ke, tables, weight, free, lam_s, lam_c))
    A = operator_csr(Ke, tables, weight, free, lam_s, lam_c)
    xf = x.reshape(-1, 1)
    lerr = float((torch.sparse.mm(A, xf).reshape(-1, 2) - want).abs().max())
    if not lerr <= FEM_LIBRARY_RTOL * scale:
        raise RuntimeError(f'fem_operator {name}: the library product is off '
                           f'by {lerr} > {FEM_LIBRARY_RTOL} x {scale}')
    # the kernel as the path calls it (bound once a solve, called once an
    # iteration) and the library call, in turns: at the path's systems both
    # are host time, which the card's shared host makes noisy; the median
    # of FEM_TURNS turns each
    op = fem.bind_elastic_operator(Ke, tables, weight, free, lam_s, lam_c)
    turns = [(cuda_time(lambda: op(x)), cuda_time(lambda: torch.sparse.mm(
        A, xf))) for _ in range(FEM_TURNS)]
    ms, lms = (float(np.median(t)) for t in zip(*turns))
    del A
    nv, nt, nl = x.shape[0], Ke.shape[0], weight.shape[0]
    row = kernel_row('fem_operator', (nv, nt, nl), name, max(errs), ms, pms,
                     fem_bound(nv, nt, *listed_links(tables)), lms)
    row['form'] = f'G{tables["group"]}'
    row['device_us'] = form_us[row['form']]
    row['form_device_us'] = form_us
    row.update(fem.operator_kernel_attrs(x.dtype, tables['group']))
    log_rows([row])
    log(f'[kernel] fem_operator {(nv, nt, nl)} {name}: max|y| {scale:.4g}; '
        f'form {row["form"]} ({row["registers"]} registers, '
        f'{row["local_bytes"]} B spilled, {row["blocks_per_sm"]} blocks a '
        f'SM); device us by G {json.dumps(form_us)}')
    return row


def _cartesian(nx, ny, pitch, x0):
    """(verts, tris) of an nx x ny vertex grid, alternating diagonals."""
    import numpy as np
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny))
    v = np.stack([xs.ravel(), ys.ravel()], -1) * pitch + [x0, 0.0]
    j, i = np.meshgrid(np.arange(ny - 1), np.arange(nx - 1), indexing='ij')
    a = (j * nx + i).ravel()
    flip = ((i + j) % 2).ravel()[:, None] == 1
    t0 = np.where(flip, np.stack([a, a + 1, a + nx + 1], -1),
                  np.stack([a, a + 1, a + nx], -1))
    t1 = np.where(flip, np.stack([a, a + nx + 1, a + nx], -1),
                  np.stack([a + 1, a + nx + 1, a + nx], -1))
    return v, np.concatenate([t0, t1])


FEM_LINKS = 100000      # phase 3's synthetic pair


def fem_pair_system(dev, nl=FEM_LINKS):
    """(x, Ke, tables, weight, free, lam_s, lam_c) of phase 3's synthetic
    system: a pair of 1000 x 500-vertex cartesian meshes (1000 x 1000
    vertices, 2M DOF, the first locked) and ``nl`` links, each between the
    same place on both meshes, seeded; f32 on ``dev``."""
    import numpy as np
    import torch
    from feabas_tpu_torch.ops import fem
    rng = np.random.default_rng(SEED)
    v0, t0 = _cartesian(1000, 500, 10.0, 0.0)
    v1, t1 = _cartesian(1000, 500, 10.0, 2.5)
    verts = np.concatenate([v0, v1])
    tris = np.concatenate([t0, t1 + len(v0)])
    l0 = np.sort(rng.integers(0, len(t0), nl))
    b0 = rng.dirichlet(np.ones(3), nl)
    b1 = rng.dirichlet(np.ones(3), nl)
    idx = torch.as_tensor(tris, device=dev)
    tables = fem.operator_tables(
        idx, len(verts), idx[l0], torch.as_tensor(b0, dtype=torch.float32,
                                                  device=dev),
        idx[l0 + len(t0)], torch.as_tensor(b1, dtype=torch.float32,
                                           device=dev))
    B, a2 = fem.shape_matrices(torch.as_tensor(verts[tris], dtype=torch.float32,
                                               device=dev))
    Ke = fem.eng_element_stiffness(
        B, a2, torch.ones(len(tris), device=dev),
        torch.full((len(tris),), 0.3, device=dev)).contiguous()
    del B, a2
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((len(verts), 2), generator=g, device=dev)
    weight = torch.rand(nl, generator=g, device=dev)
    free = torch.ones((len(verts), 1), device=dev)
    free[:len(v0)] = 0.0
    return x, Ke, tables, weight, free, 0.37, 1.0


def check_fem(dev):
    """Phase 3, the general CG operator on the synthetic 2M-DOF pair
    (``fem_pair_system``, ``fem_row``). The phase-7 path's own systems are
    held so in ``fem_path_rows``."""
    return [fem_row('synthetic pair, 2M DOF, 1e5 links',
                    *fem_pair_system(dev))]


FEM_TIMED = 2           # shapes of phases 4-6 timed in full: the most
                        # launched of each path


def fem_check(name, x, Ke, tables, weight, free, lam_s, lam_c):
    """The operator on one system at the G its tables chose: bit-equal to
    itself across two launches and within FEM_RTOL of max|y| of the plain
    version; ``fem_row`` without the timing."""
    import torch
    from feabas_tpu_torch.ops import fem
    want = fem.elastic_operator_plain(x, Ke, tables, weight, free, lam_s,
                                      lam_c)
    op = fem.bind_elastic_operator(Ke, tables, weight, free, lam_s, lam_c)
    got, again = op(x), op(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, again):
        raise RuntimeError(f'fem_operator {name}: two launches differ')
    if not err <= FEM_RTOL * float(want.abs().max()):
        raise RuntimeError(f'fem_operator {name}: max_abs_err {err}')
    return err


def fem_path_rows(dev, systems, launched, phase='phase-7', timed=None):
    """The operator on each system a path bound it to (``OperatorSpy``'s
    copies of the first system of each (NV, NT, L) shape, with the lambdas
    the path gave it), on a seeded x: the ``timed`` shapes the path
    launched most (all with None) through ``fem_row`` (checked and timed),
    every other one through ``fem_check``. ``launched``: {'NVxNTxL': the
    path's launches}."""
    import torch
    rows, others = [], []
    keys = sorted(systems, key=lambda k: -launched.get('x'.join(map(str, k)),
                                                       0))
    for i, (nv, nt, nl) in enumerate(keys):
        stage, *system = systems[(nv, nt, nl)]
        g = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn((nv, 2), generator=g, device=dev,
                        dtype=system[0].dtype)
        n = launched.get(f'{nv}x{nt}x{nl}', 0)
        name = f'{phase} {stage} system ({n} launches)'
        if timed is None or i < timed:
            rows.append(fem_row(name, x, *system))
        else:
            others.append(fem_check(name, x, *system))
    if others:
        log(f'[kernel] fem_operator: {len(others)} more {phase} shapes, each '
            f'bit-equal across two launches, max_abs_err <= {max(others):.3e} '
            'against the plain version')
    return rows


class OperatorSpy:
    """While active, keeps a copy of the first system of each (NV, NT, L)
    shape that ``fem.bind_elastic_operator`` is bound to, and the stage
    (``stage``) that bound it; copies launch no counted kernel."""

    def __init__(self):
        self.systems, self.stage = {}, ''

    def __enter__(self):
        import torch
        from feabas_tpu_torch.ops import fem
        self._bind = bind = fem.bind_elastic_operator

        def spy(Ke, tables, weight, free, lam_s, lam_c):
            key = (tables['nv'], tables['nt'], tables['nl'])
            if key not in self.systems:
                self.systems[key] = (self.stage, Ke.clone(), {
                    k: v.clone() if torch.is_tensor(v) else v
                    for k, v in tables.items()}, weight.clone(), free.clone(),
                    float(lam_s), float(lam_c))
            return bind(Ke, tables, weight, free, lam_s, lam_c)

        fem.bind_elastic_operator = spy
        return self

    def __exit__(self, *exc):
        from feabas_tpu_torch.ops import fem
        fem.bind_elastic_operator = self._bind


def _copied(x):
    """x with every tensor in it cloned (tuples, lists and dicts walked)."""
    import torch
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_copied(v) for v in x)
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    return x


class FirstCall:
    """While active, keeps a copy of the arguments and the result of the
    first call of ``module.<name>`` made while ``armed`` is true."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.armed, self.args, self.result = True, None, None

    def __enter__(self):
        self._fn = fn = getattr(self.module, self.name)

        def spy(*a, **k):
            keep = self.armed and self.args is None
            if keep:
                args = (_copied(a), _copied(k))
            out = fn(*a, **k)
            if keep:
                self.args, self.result = args, _copied(out)
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._fn)


class FirstOfShape:
    """While active, keeps a copy of the arguments of the first call of
    ``module.<name>`` for each shape ``key(args)``, with the covered flag
    its result gave; copies launch no counted kernel."""

    def __init__(self, module, name, key):
        self.module, self.name, self.key = module, name, key
        self.calls = {}

    def __enter__(self):
        self._fn = fn = getattr(self.module, self.name)

        def spy(*a, **k):
            key = self.key(a)
            keep = key not in self.calls
            if keep:
                args = (_copied(a), _copied(k))
            out = fn(*a, **k)
            if keep:
                self.calls[key] = args + (_copied(out[1]),)
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._fn)


def _same_bits(a, b):
    """True when a and b (tensors or arrays, or tuples of them) hold the
    same bits."""
    import numpy as np
    import torch
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same_bits, a, b))
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


# [determinism] entries: (solve, system shape), filled by the phases
DETERMINISM = []


def determinism_check(solve, shape, fn, path_result):
    """``fn()`` (a solve on inputs a path gave it) twice: both bit-equal to
    each other and to what the path got. Records the solve and fails
    otherwise."""
    import torch
    first, second = fn(), fn()
    torch.cuda.synchronize()
    if not (_same_bits(first, second) and _same_bits(first, path_result)):
        raise RuntimeError(f'{solve} {shape}: two calls on equal inputs '
                           'differ, or differ from the path')
    DETERMINISM.append((solve, shape))


def log_determinism():
    if DETERMINISM:
        log('[determinism] ' + '; '.join(
            f'{s} {tuple(shape)} bit-equal' for s, shape in DETERMINISM))


def synthetic_stack(S=4, ragged=False, seed=0, n_pts=5):
    """S port meshes of 100^2 linked by seeded matches and moved by a
    seeded cumulative drift, the first locked, packed as a stacked window
    system (lattice-packed when the topologies agree)."""
    import numpy as np
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.parallel import window
    rng = np.random.default_rng(seed)
    meshes = []
    for z in range(S):
        m = Mesh.from_bbox((0, 0, 100, 100), cartesian=not ragged,
                           mesh_size=25 + (5 * z if ragged else 0), uid=z,
                           name=f'z{z}')
        m.locked = z == 0
        meshes.append(m)
    drift = np.cumsum(rng.normal(0, 2.0, (S, 2)), axis=0)
    xs, ys = np.meshgrid(np.linspace(10, 90, n_pts),
                         np.linspace(10, 90, n_pts))
    pts = np.stack([xs.ravel(), ys.ravel()], -1)
    links = []
    for z in range(S - 1):
        p1 = pts + rng.uniform(-1, 1, pts.shape)
        tid0 = meshes[z].tri_finder(pts, gear='INITIAL')
        tid1 = meshes[z + 1].tri_finder(p1, gear='INITIAL')
        links.append({
            'idx0': meshes[z].triangles[tid0],
            'bary0': meshes[z].cart2bary(pts, tid0, gear='INITIAL'),
            'idx1': meshes[z + 1].triangles[tid1],
            'bary1': meshes[z + 1].cart2bary(p1, tid1, gear='INITIAL'),
            'weight': rng.uniform(0.5, 1.0, len(pts))})
    for z, m in enumerate(meshes):
        m.set_translation(drift[z], gear=('INITIAL', 'MOVING'))
    return window.build_stack_system(meshes, links)


def round_case(dev, P=3, B=24):
    """The arguments of ``match_loop._solve_round`` for one seeded round of
    the fused match schedule: P pairs of 200^2 meshes with B blocks each,
    the last fifth padding (weight 0), built as ``fused_rounds_batched``
    builds them."""
    import numpy as np
    import torch
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.ops import fem, match_loop
    rng = np.random.default_rng(SEED + 2)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dt, device=dev)

    m = Mesh.from_bbox((0, 0, 200, 200), cartesian=True, mesh_size=30)
    verts, tris = m.vertices_w_offset('INITIAL'), m.triangles
    V, E = len(verts), len(tris)
    shape1 = t(np.broadcast_to(verts, (P, V, 2)))
    pos = shape1 + t(rng.normal(0, 0.5, (P, V, 2)))
    tris_flat = match_loop._flat_idx(
        t(np.broadcast_to(tris, (P, E, 3)), torch.int64), V).reshape(-1, 3)
    Bm, a2 = fem.shape_matrices(shape1.reshape(-1, 2)[tris_flat])
    Ke = fem.eng_element_stiffness(Bm, a2, t(np.ones(P * E)),
                                   t(np.full(P * E, 0.3)))
    by_corner = fem.fixed_sum(tris_flat, P * V)
    dK = by_corner(torch.diagonal(Ke, dim1=1, dim2=2).reshape(-1, 2)
                   ).reshape(P, V, 2)
    idx_a = t(tris[rng.integers(0, E, (P, B))], torch.int64)
    idx0_a = t(tris[rng.integers(0, E, (P, B))], torch.int64)
    bary_a = t(rng.dirichlet(np.ones(3), (P, B)))
    bary0_a = t(rng.dirichlet(np.ones(3), (P, B)))
    targets = (match_loop._bary_eval(pos, idx_a, bary_a)
               + t(rng.normal([2.0, -1.0], 0.5, (P, B, 2))))
    valid = t(np.arange(B) < B - B // 5).expand(P, B)
    w = t(rng.uniform(0.3, 1.0, (P, B))) * valid
    rs = match_loop._round_system(tris_flat, V, idx_a, bary_a, V, idx0_a,
                                  valid)
    return (pos, shape1, Ke, by_corner, dK, rs, idx_a, bary_a, w, targets,
            0.35, 1e-8, 600, dK, bary0_a)


def solve_cases(dev):
    """Seeded small inputs of the four solves that summed with CUDA
    ``index_add_`` before their sums took a fixed order: {name: fn}, each
    fn running its solve once from the same inputs and returning what it
    gives (``fem_tune.py repeat`` and tests/test_torch_determinism.py)."""
    import numpy as np
    import torch
    from feabas_tpu_torch import optimizer, state
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.ops import match_loop
    from feabas_tpu_torch.parallel import window
    f32 = torch.float32
    rng = np.random.default_rng(SEED)

    # the fused ENG solve: three meshes, the first locked, linked pairwise
    slm = optimizer.SLM([Mesh.from_bbox(b, cartesian=True, mesh_size=20,
                                        uid=i, locked=i == 0)
                         for i, b in enumerate(((0, 0, 100, 100),
                                                (80, 0, 180, 100),
                                                (0, 80, 100, 180)))],
                        device=dev)
    for a, b, box in ((0, 1, (82, 98, 5, 95)), (0, 2, (5, 95, 82, 98)),
                      (1, 2, (82, 98, 82, 98))):
        pts = np.stack([rng.uniform(box[0], box[1], 30),
                        rng.uniform(box[2], box[3], 30)], -1)
        slm.add_link_from_coordinates(a, b, pts, pts + rng.normal(
            [3.0, -2.0], 0.3, pts.shape))
    snap = slm._snapshot_positions('MOVING')

    def fused_eng():
        slm._restore_positions(snap, 'MOVING')
        slm.optimize_linear(stiffness_lambda=-0.5, crosslink_lambda=-1.0,
                            tol=1e-6)
        return tuple(m.vertices_w_offset('MOVING') for m in slm.meshes)

    # the stacked window solve, lattice-packed with its link transpose (the
    # align path's form) and ragged with neither (the fixed-order sums)
    def stack(ragged, linc):
        system = synthetic_stack(S=5, ragged=ragged)
        S, V = system['u'].shape[:2]
        if linc:
            system['linc'] = window.build_link_transpose(system['links'], S,
                                                         V)
        ts = state.window_system_to_device(system, dev, f32)
        modes = window.stack_rigid_modes(system)
        return lambda: window.stack_solve(
            ts['verts0'], ts['u'], ts['tris'], ts['multiplier'],
            ts['poisson'], ts['links'], ts['r_rest'], ts['free'], tol=1e-7,
            maxiter=500, modes=None if modes is None else state.to_tensors(
                modes, dev, f32), lam_ratio=1.0,
            grid_shape=system.get('grid_shape'), linc=ts.get('linc'),
            sten=ts.get('sten'))

    # relax_mesh: the middle of a jittered 200^2 mesh free
    rm = Mesh.from_bbox((0, 0, 200, 200), cartesian=False, mesh_size=25)
    v = rm.vertices_w_offset('INITIAL')
    bent = v + rng.normal(0, 2.0, v.shape)
    free = np.linalg.norm(v - [100, 100], axis=-1) < 60

    def relax():
        rm.set_vertices(bent, 'MOVING', offset=(0.0, 0.0))
        optimizer.relax_mesh(rm, free_vertices=free, device=dev)
        return rm.vertices_w_offset('MOVING')

    round_args = round_case(dev)
    return {'_linear_solve_eng': fused_eng,
            '_solve_round': lambda: match_loop._solve_round(*round_args),
            'stack_solve, lattice + link transpose': stack(False, True),
            'stack_solve, ragged, fixed-order sums': stack(True, False),
            'relax_mesh': relax}


# phase 7: the nonlinear align slice
NL_S = 4
WRINKLE_LABEL = 50                     # the shipped 'wrinkle' material
WRINKLE_PX = 24                        # band width, mask px at mip 4
MASK_MIP = 4


def write_wrinkle_masks(wd, names, size=SECTION >> MASK_MIP):
    """A material mask PNG at mip 4 for each section: label 0 over the
    section, and on sections 1 and 2 a band of label 50 about WRINKLE_PX
    wide along a seeded line through the middle third."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(SEED + 7)
    d = os.path.join(wd, 'align', 'material_masks')
    os.makedirs(d, exist_ok=True)
    yy, xx = np.mgrid[:size, :size] + 0.5
    for z, n in enumerate(names):
        mask = np.zeros((size, size), np.uint8)
        if z in (1, 2):
            a = rng.uniform(0, np.pi)
            c = size / 2 + rng.uniform(-size / 6, size / 6, 2)
            dist = (xx - c[0]) * np.cos(a) + (yy - c[1]) * np.sin(a)
            mask[np.abs(dist) < WRINKLE_PX / 2] = WRINKLE_LABEL
        if not cv2.imwrite(os.path.join(d, n + '.png'), mask):
            raise OSError(f'could not write the mask of {n}')


def run_nonlinear(dev):
    """Phase 7: the first NL_S sections of the phase-5 stack, sections 1 and
    2 carrying a band of the nonlinear 'wrinkle' material in their masks,
    through the align CLI (meshing, matching, optimization, rendering);
    then the general CG operator held against its plain version on each
    system shape the path bound it to (``fem_path_rows``). Returns
    (launches, launches by shape, stage seconds, the operator's rows)."""
    import numpy as np
    import torch
    from feabas_tpu_torch import aligner
    from feabas_tpu_torch import device as device_mod
    from feabas_tpu_torch.mesh import Mesh
    from feabas_tpu_torch.scripts import align_main

    t0 = time.perf_counter()
    sections, drift = make_stack(dev, NL_S)
    root = tempfile.mkdtemp(prefix='feabas_chip_nonlinear_')
    stacked = []
    solve = aligner.Stack._sharded_window_solve

    def solve_spy(self, *a, **k):
        stacked.append(solve(self, *a, **k) and self.last_window_sharded)
        return stacked[-1]

    aligner.Stack._sharded_window_solve = solve_spy
    spy = OperatorSpy().__enter__()
    try:
        wd, names = setup_align_workdir(root, sections)
        del sections
        write_wrinkle_masks(wd, names)
        log(f'[nonlinear] {NL_S} sections of {SECTION}x{SECTION} uint8, '
            f'wrinkle bands in {names[1]} and {names[2]}, set-up '
            f'{time.perf_counter() - t0:.2f} s')
        device_mod.reset_launch_counts()
        stage_s, by_stage = {}, {}
        for mode in ('meshing', 'matching', 'optimization', 'rendering'):
            spy.stage = mode
            t = time.perf_counter()
            align_main.main(['--mode', mode])
            torch.cuda.synchronize()
            stage_s[mode] = time.perf_counter() - t
            by_stage[mode] = device_mod.launch_counts_by_shape()['fem_operator']
        launches = device_mod.launch_counts()
        by_shape = device_mod.launch_counts_by_shape()
        n_match = sum(by_stage['matching'].values())
        n_opt = sum(by_stage['optimization'].values()) - n_match
        log('[nonlinear] stage seconds ' + json.dumps(
            {k: round(v, 3) for k, v in stage_s.items()})
            + f'; fem_operator launches: matching {n_match}, optimization '
            f'{n_opt}; launches {launches}')
        counts, errs = align_pair_checks(wd, names, drift)
        if not stacked or any(stacked):
            raise RuntimeError(f'window solves {stacked}: the stacked solve '
                               'took a window of nonlinear sections')
        flips = {}
        for n in names:
            t = Mesh.from_h5(os.path.join(wd, 'align', 'tform', n + '.h5'))
            flips[n] = int(t.flipped_triangles('MOVING').size)
        if any(flips.values()):
            raise RuntimeError(f'flipped triangles in the tforms: {flips}')
        wrinkled = Mesh.from_h5(os.path.join(wd, 'align', 'mesh',
                                             names[1] + '.h5'))
        curves = [g['knots'] is not None for g in wrinkled.element_arrays()]
        if not any(curves):
            raise RuntimeError(f'{names[1]}: no element group carries the '
                               'wrinkle curve')
        ccs = align_overlay_ccs(wd, names)
        if not min(ccs) > 0.85:
            raise RuntimeError(f'rendered overlay cc {ccs}, median match '
                               f'errors {errs}')
        if n_match <= 0 or n_opt <= 0:
            raise RuntimeError(f'fem_operator launched {n_match} times in '
                               f'matching and {n_opt} in optimization')
        for name in ('dog_filter', 'mesh_raster'):
            if launches[name] <= 0:
                raise RuntimeError(f'{name} was not launched by the '
                                   'nonlinear align path')
        if any(m == 'jax' or m.startswith('jax.') for m in sys.modules):
            raise RuntimeError('jax was imported')
        log(f'[nonlinear] {len(counts)} pairs matched ({min(counts)}-'
            f'{max(counts)} matches), median match errors '
            f'{np.round(errs, 4).tolist()} px, window solves {stacked} '
            f'(not stacked), element groups of {names[1]} with a curve '
            f'{curves}, no flipped triangle, overlay cc {min(ccs):.5f}-'
            f'{max(ccs):.5f}')
        # after the counts were read: these launches compare, not count
        spy.__exit__()
        rows = fem_path_rows(dev, spy.systems, by_shape['fem_operator'])
        return launches, by_shape, stage_s, rows
    finally:
        aligner.Stack._sharded_window_solve = solve
        spy.__exit__()
        shutil.rmtree(root, ignore_errors=True)


# ------------------- phase 3: the thumbnail path's kernels ------------------- #

MATCH_GAP = 1e-5        # S agrees to ~1e-6 (f32 sums of 48 products in
                        # another order): below this gap an argmax may flip
DESC_ATOL = 1e-5        # unit descriptors, f32 sums of 2401 products


def peak_library(f, mask, size):
    """The peak response through one 2-D ``F.max_pool2d`` on the
    -inf-padded plane, and the compares."""
    import torch
    import torch.nn.functional as F
    a = f.abs()
    lo, hi = (size - 1) // 2, size // 2
    mx = F.max_pool2d(F.pad(a[None, None], (lo, hi, lo, hi),
                            value=float('-inf')), size, stride=1)[0, 0]
    peaks = (a >= mx) & (a > 0)
    if mask is not None:
        peaks = peaks & (mask > 0)
    return torch.where(peaks, a, torch.full_like(a, float('-inf')))


def patch_library(img, z, f, tables, proj_num, Rp):
    """The descriptors' product through a patch gather and one
    ``torch.matmul`` (the blend and normalisation are not included)."""
    import torch
    import torch.nn.functional as F
    W = tables[0]
    Dp = 2 * Rp + 1
    imgp = F.pad(img[None, None], (Rp + 1,) * 4, mode='replicate')[0, 0]
    ar = torch.arange(Dp, device=img.device)
    zz = z.long()
    Pm = imgp[zz[:, 1, None, None] + ar[None, :, None],
              zz[:, 0, None, None] + ar[None, None, :]]
    return torch.matmul(Pm.reshape(zz.shape[0], -1),
                        W.reshape(-1, W.shape[-1]).T)


def match_library(d0, v0, d1, v1, proj_num, exhaustive):
    """The match through ``torch.matmul``, ``max``, ``topk(2)`` and
    ``argmax`` per variant (no promise on ties)."""
    import torch
    from feabas_tpu_torch.ops import lradon
    a0 = d0.reshape(d0.shape[0], -1)
    vmask = v1[:, None] & v0[None, :]
    ninf = torch.tensor(float('-inf'), device=d0.device)
    variants = lradon._variants(d1, proj_num) if exhaustive \
        else d1.reshape(1, d1.shape[0], -1)
    best = None
    for ri, vr in enumerate(variants):
        S = torch.where(vmask, torch.matmul(vr, a0.T), ninf)
        m = S.max()
        if best is None or bool(m > best[0]):
            best = (m, ri, S)
    S = best[2]
    top2 = S.topk(min(2, S.shape[1]), dim=1)
    back = S.argmax(dim=0)
    top, i0 = top2.values[:, 0], top2.indices[:, 0]
    second = top2.values[:, -1]
    conf = torch.where(top > 0, 1 - second.clamp(min=0) / top.clamp(min=1e-6),
                       torch.zeros_like(top))
    mutual = (back[i0] == torch.arange(S.shape[0], device=S.device)) & v1
    return i0, top, conf, mutual, best[1]


def _unit_descriptors(g, dev, n, shape=(6, 8)):
    import torch
    d = torch.randn((n,) + shape, generator=g, device=dev)
    d = d - d.mean(dim=(1, 2), keepdim=True)
    return d / torch.linalg.norm(d.reshape(n, -1), dim=-1)[:, None, None]


def lradon_cases(dev, kernel):
    """[(name, thunk)] of one thumbnail-path kernel's phase-3 cases. A
    thunk makes the case on ``dev`` from a seed: a dict with the wrapper's
    ``args``, ``timed`` (timed beside a library call), ``on_path`` (what
    the thumbnail path launches; ``timed`` where absent) and, for some,
    ``post`` (a further check of the kernel's result)."""
    import numpy as np
    import torch
    from feabas_tpu_torch.ops import lradon

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED + 7)

    if kernel == 'peak_detect':
        def plane(h, w, size, mask=False, levels=None, timed=False):
            def make():
                g = gen()
                f = torch.randn((h, w), generator=g, device=dev)
                if levels:                 # few distinct values: plateaus
                    f = torch.round(f * levels) / levels
                m = None
                if mask:
                    m = (torch.rand((h, w), generator=g, device=dev)
                         > 0.2).to(torch.float32)
                return {'args': (f, m, size), 'timed': timed,
                        'on_path': timed and not mask}
            return make
        return [('2048^2 size 10', plane(2048, 2048, 10, timed=True)),
                ('2048^2 size 10, mask', plane(2048, 2048, 10, mask=True,
                                               timed=True)),
                ('1x1', plane(1, 1, 10)),
                ('7x300', plane(7, 300, 10, mask=True)),
                ('size 3', plane(200, 333, 3)),
                ('size 7', plane(200, 333, 7, mask=True)),
                ('plateau', plane(512, 640, 10, levels=2)),
                # the kernel's window edges (1, 2 and its widest, 31 and
                # 32) and a plane whose width is no multiple of 4 (4-byte
                # loads) and whose sides are no multiple of the tile
                ('size 1', plane(300, 260, 1)),
                ('size 2', plane(300, 260, 2, mask=True)),
                ('size 31', plane(300, 260, 31)),
                ('size 32', plane(300, 260, 32, mask=True)),
                ('2049 x 2047 size 10, mask', plane(2049, 2047, 10,
                                                    mask=True))]

    if kernel == 'lradon_patch':
        def keypoints(h, w, K, border=False, timed=False, radius=15,
                      geom=(6, 8, 3)):
            def make():
                D, offs, Rp = lradon._desc_params(*geom, radius)
                g = gen()
                img = torch.rand((h, w), generator=g, device=dev) * 255
                xy = torch.rand((K, 2), generator=g, device=dev) \
                    * torch.tensor([w - 1.0, h - 1.0], device=dev)
                if border:
                    # every corner and border, offsets 0 and just under 1
                    e = 1.0 - 2.0 ** -20
                    pts = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1),
                           (w / 2, 0), (0, h / 2), (w - 1, h / 2),
                           (w / 2, h - 1), (e, e), (w - 2 + e, e),
                           (e, h - 2 + e), (w - 2 + e, h - 2 + e),
                           (5 + e, 7), (5, 7 + e), (1, 1), (w - 2, h - 2)]
                    xy[:len(pts)] = torch.tensor(pts, device=dev)
                z0 = torch.floor(xy)
                tables = lradon._stencil_tensors(*geom, D, offs, Rp, dev)
                return {'args': (img, z0.to(torch.int32) + 1, xy - z0, tables,
                                 geom[0], Rp), 'timed': timed}
            return make
        # a block holds the sparse table and one blended patch per warp:
        # 16 warps at radius 15 (49^2 patches), 4 at radius 30 (93^2), 1 at
        # radius 45 (135^2, its 416-tap bins in 120 KB of table); the 4 x 6
        # geometry has 24 bins, under one per lane
        return [('K 5000', keypoints(2048, 2048, 5000, timed=True)),
                ('K 64, borders and corners', keypoints(300, 260, 64,
                                                        border=True)),
                ('K 4096, 3000x2000', keypoints(2000, 3000, 4096)),
                ('radius 30, groups of 4', keypoints(300, 260, 70,
                                                     border=True, radius=30)),
                ('radius 45, one per block', keypoints(300, 260, 37,
                                                       border=True,
                                                       radius=45)),
                ('4 x 6 bins, width 1, radius 9.5',
                 keypoints(300, 260, 300, border=True, radius=9.5,
                           geom=(4, 6, 1)))]

    def sets(K0, K1, exhaustive=True, mask0=None, dup=False, variant=None,
             timed=False, shape=(6, 8)):
        def make():
            P = shape[0]
            perms = lradon._variant_perms(P, shape[1], dev).long()
            g = gen()
            d0 = _unit_descriptors(g, dev, K0, shape)
            d1 = _unit_descriptors(g, dev, K1, shape)
            v0 = torch.rand(K0, generator=g, device=dev) > 0.1
            v1 = torch.rand(K1, generator=g, device=dev) > 0.1
            post = None
            if mask0 is not None:
                v0[:] = mask0
            if dup:
                # columns K0/2.. repeat columns 0..; rows K1/2.. repeat rows
                # 0..; half of d1 are noisy copies of d0, so tops are ties
                h0, h1 = K0 // 2, K1 // 2
                n = min(h0, h1)
                d1[:n] = d0[:n]
                d0[h0:2 * h0] = d0[:h0]
                d1[h1:2 * h1] = d1[:h1]
                v0[:], v1[:] = True, True

                def post(got):
                    i0, top, conf, mutual, rot = got
                    if not (bool((i0 < h0).all()) and int(rot) == 0):
                        raise RuntimeError('duplicates: a later column won')
                    if bool(mutual[h1:2 * h1].any()):
                        raise RuntimeError('duplicates: a later row won')
                    if not (bool(mutual[:n].all())
                            and float(conf[:n].abs().max()) < 1e-6):
                        raise RuntimeError('duplicates: exact copies are not '
                                           'mutual ties')
            if variant is not None:
                # variant r of d1 equals d0 on the first rows
                n = min(K0, K1) // 2
                inv = torch.argsort(perms[variant])
                d1[:n] = d0[:n].reshape(n, -1)[:, inv].reshape(n, P, -1)
                v0[:n], v1[:n] = True, True

                def post(got):
                    if int(got[4]) != variant:
                        raise RuntimeError(f'best_rot {int(got[4])}, made '
                                           f'for variant {variant}')
            return {'args': (d0, v0, d1, v1, P, exhaustive), 'timed': timed,
                    'post': post}
        return make
    return [('5000 x 5000', sets(5000, 5000, timed=True)),
            ('64 x 4096', sets(64, 4096)),
            ('side 0 masked', sets(300, 200, mask0=False)),
            ('duplicates', sets(512, 256, dup=True)),
            ('not exhaustive', sets(1000, 777, exhaustive=False)),
            ('variant 0', sets(400, 300, variant=0)),
            ('variant 1..P-1', sets(400, 300, variant=3)),
            ('variant P..2P-1', sets(400, 300, variant=8)),
            # the kernels' other instantiation (any dlen), and a row tile
            # cut short beside 24 column tiles that no chunk count divides
            ('dlen 24 (4 x 6)', sets(700, 900, shape=(4, 6))),
            ('100 x 3001', sets(3001, 100))]


def _match_disagreement(got, want, args):
    """Hold a kernel match against the plain version's. Returns (max abs
    error of top, rows whose result may differ because the plain
    version's top two are closer than MATCH_GAP); raises on any other
    difference."""
    import torch
    from feabas_tpu_torch.ops import lradon
    d0, v0, d1, v1, P, exhaustive = args
    i0, top, conf, mutual, rot = got
    pi0, ptop, pconf, pmutual, prot = want
    K1 = d1.shape[0]
    a0 = d0.reshape(d0.shape[0], -1)
    ninf = torch.tensor(float('-inf'), device=d0.device)
    vmask = v1[:, None] & v0[None, :]
    if exhaustive:
        vmax = torch.stack([torch.where(vmask, vr @ a0.T, ninf).max()
                            for vr in lradon._variants(d1, P)])
        if int(rot) != int(prot):
            best2 = vmax.topk(2).values
            if float(best2[0] - best2[1]) >= MATCH_GAP:
                raise RuntimeError(f'best_rot {int(rot)} != plain '
                                   f'{int(prot)}, variant maxima {vmax}')
            return float('nan'), K1
        d1v = lradon._variants(d1, P)[int(prot)]
    else:
        if int(rot) != 0:
            raise RuntimeError(f'best_rot {int(rot)} without a search')
        d1v = d1.reshape(K1, -1)
    S = torch.where(vmask, d1v @ a0.T, ninf)

    def gap(S, dim):
        if S.shape[dim] < 2:
            return torch.full((S.shape[1 - dim],), float('inf'),
                              device=S.device)
        t = S.topk(2, dim=dim).values
        t0, t1 = (t[:, 0], t[:, 1]) if dim == 1 else (t[0], t[1])
        # an all -inf line has its argmax at 0 in both versions
        return torch.where(torch.isfinite(t0), t0 - t1,
                           torch.full_like(t0, float('inf')))
    close = (gap(S, 1) < MATCH_GAP) | (gap(S, 0)[pi0] < MATCH_GAP)
    sure = ~close
    if not torch.equal(i0[sure], pi0[sure]):
        raise RuntimeError('i0 differs outside close rows')
    if not torch.equal(mutual[sure], pmutual[sure]):
        raise RuntimeError('mutual differs outside close rows')
    fin = torch.isfinite(ptop)
    if not torch.equal(torch.isfinite(top), fin):
        raise RuntimeError('top: -inf rows differ')
    err = float((top[fin] - ptop[fin]).abs().max()) if bool(fin.any()) else 0.0
    if not err <= MATCH_GAP:
        raise RuntimeError(f'top differs by {err}')
    held = sure & (ptop > 0.1)
    cerr = float((conf[held] - pconf[held]).abs().max()) \
        if bool(held.any()) else 0.0
    if not cerr <= MATCH_GAP:
        raise RuntimeError(f'conf differs by {cerr}')
    if not torch.equal(conf[~fin], pconf[~fin]):
        raise RuntimeError('conf of rows without a partner differs')
    return max(err, cerr), int(close.sum())


def lradon_compare(kernel, case):
    """One launch of a thumbnail-path kernel on a case of ``lradon_cases``
    against its plain version. Returns (max abs error, close rows or
    None); raises where they disagree."""
    import torch
    from feabas_tpu_torch.ops import lradon
    args = case['args']
    if kernel == 'peak_detect':
        got = lradon.peak_response(*args)
        want = lradon.peak_response_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and got.dtype == want.dtype):
            raise RuntimeError(
                f'peak_detect: {int((got != want).sum())} pixels differ')
        return 0.0, None
    if kernel == 'lradon_patch':
        got = lradon.lradon_patch(*args)
        want = _patch_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (err <= DESC_ATOL and got.shape == want.shape):
            raise RuntimeError(f'lradon_patch: max abs error {err}')
        return err, None
    got = lradon.lradon_match(*args)
    want = lradon.lradon_match_plain(*args)
    torch.cuda.synchronize()
    err, close = _match_disagreement(got, want, args)
    if case.get('post') is not None:
        case['post'](got)
    return err, close


def _patch_plain(img, z, f, tables, proj_num, Rp):
    from feabas_tpu_torch.ops import lradon
    return lradon.lradon_patch_plain(img, z, f, tables[0], proj_num, Rp)


def _lradon_bound(kernel, args):
    """Bound of one call from its inputs: each input read once, each
    output written once, and the operations the function needs."""
    if kernel == 'peak_detect':
        f, mask, size = args
        px = f.numel()
        return bound(px * (2 * size + 3),
                     px * (8 + (4 if mask is not None else 0)))
    if kernel == 'lradon_patch':
        img, z, f, tables = args[:4]
        W = tables[0]
        K, out = z.shape[0], W.shape[1]
        # the products with the table's non-zero taps (a beam touches a
        # small part of its patch), then the blend and the normalisation
        return bound(K * (2 * int(W.count_nonzero()) + 12 * out),
                     4 * (img.numel() + 4 * K + W.numel() + K * out))
    d0, v0, d1, v1, P, exhaustive = args
    K0, K1, dlen = d0.shape[0], d1.shape[0], d0.shape[1] * d0.shape[2]
    nvar = 2 * P if exhaustive else 1
    # the products of every variant, then a compare per reduction and entry
    return bound(nvar * 2 * K0 * K1 * dlen + (nvar + 3) * K0 * K1,
                 4 * (K0 + K1) * dlen + K0 + K1 + 13 * K1 + 4)


# call ms of the first versions of K16 / K17 (PERF.md), printed beside
# this run's for reference; the kernels line carries only this run's
FIRST_MS = {('lradon_patch', 'K 5000'): 0.4842,
            ('lradon_patch', 'K 64, borders and corners'): 0.1727,
            ('lradon_patch', 'K 4096, 3000x2000'): 0.3454,
            ('lradon_patch', 'radius 30, groups of 4'): 0.4833,
            ('lradon_patch', 'radius 45, one per block'): 0.8326,
            ('lradon_match', '5000 x 5000'): 1.7084,
            ('lradon_match', '64 x 4096'): 0.0762}


def check_lradon(dev):
    """Phase 3, the thumbnail path's three kernels: every case of
    ``lradon_cases`` against the plain version, the main-path shapes also
    timed (kernel, plain, one PyTorch library call of the same function)
    beside their bound."""
    import torch
    from feabas_tpu_torch.ops import lradon
    wrappers = {'peak_detect': lradon.peak_response,
                'lradon_patch': lradon.lradon_patch,
                'lradon_match': lradon.lradon_match}
    plains = {'peak_detect': lradon.peak_response_plain,
              'lradon_patch': _patch_plain,
              'lradon_match': lradon.lradon_match_plain}
    libraries = {'peak_detect': peak_library,
                 'lradon_patch': patch_library,
                 'lradon_match': match_library}
    rows = []
    for kernel in wrappers:
        for name, make in lradon_cases(dev, kernel):
            case = make()
            args = case['args']
            err, close = lradon_compare(kernel, case)
            timed = case['timed']
            iters, warm = (10, 0.1) if timed else (3, 0.01)
            ms = cuda_time(lambda: wrappers[kernel](*args), iters, warm)
            pms = cuda_time(lambda: plains[kernel](*args),
                            3 if kernel == 'lradon_match' else iters, warm)
            lib = cuda_time(lambda: libraries[kernel](*args),
                            3 if kernel == 'lradon_match' else iters,
                            warm) if timed else None
            if kernel == 'peak_detect':
                shape = tuple(args[0].shape)
            elif kernel == 'lradon_patch':
                shape = (args[1].shape[0], args[3][0].shape[1])
            else:
                shape = (args[2].shape[0], args[0].shape[0],
                         2 * args[4] if args[5] else 1)
            row = kernel_row(kernel, shape, name, err, ms, pms,
                             _lradon_bound(kernel, args), lib)
            # a call near the host floor is mostly host time: the device's
            # share of it, from a CUDA-graph replay
            row['device_us'] = graph_time(
                lambda: wrappers[kernel](*args), 20 if timed else 5)
            row['first_ms'] = FIRST_MS.get((kernel, name))
            row['edge'] = not case.get('on_path', timed)
            if close is not None:
                row['close_rows'] = close
            rows.append(row)
            del case, args
    torch.cuda.synchronize()
    log_rows(rows)
    return rows


# phase 3: the thumbnail matches' subpixel refinement
SUBPIXEL_SHIFT = (17.3, -9.6)         # the content at p in img1 is at p + t
SUBPIXEL_ATOL = 1e-4                  # px: f32 sums in another order


def subpixel_case(dev, size=4096, side=37, blur=1.5, seed=SEED):
    """Two size^2 uint8 views of one texture (``make_texture``, ``blur``
    px), the second shifted by SUBPIXEL_SHIFT (bilinear), their DoGs at the
    detector's sigma 3.5 (the DoG kernel), and side^2 matches: xy1 on a
    grid 64 px inside the image, xy0 = xy1 + t + N(0, 1.5 px). Returns a
    dict of the images img0, img1, dog0, dog1, the centres c0, c1
    (rounded, on the host), xy0, xy1 and the truth xy1 + t."""
    import numpy as np
    import torch
    from feabas_tpu_torch.ops.filters import masked_dog_filter
    tx, ty = SUBPIXEL_SHIFT
    world = make_texture(dev, size + 64, size + 64, seed, blur).float()
    ix, iy = int(np.floor(tx)), int(np.floor(ty))
    fx, fy = tx - ix, ty - iy

    def at(dy, dx):
        y, x = 32 + iy + dy, 32 + ix + dx
        return world[y:y + size, x:x + size]
    img1 = ((1 - fy) * ((1 - fx) * at(0, 0) + fx * at(0, 1))
            + fy * ((1 - fx) * at(1, 0) + fx * at(1, 1)))
    img0 = world[32:32 + size, 32:32 + size]
    rng = np.random.default_rng(seed)
    g = np.linspace(64, size - 64, side)
    xy1 = np.stack(np.meshgrid(g, g + 0.3), -1).reshape(-1, 2)
    truth = xy1 + np.asarray(SUBPIXEL_SHIFT)
    xy0 = truth + rng.normal(0, 1.5, xy1.shape)

    img0, img1 = (torch.round(i).to(torch.uint8) for i in (img0, img1))
    return {'img0': img0, 'img1': img1, 'dog0': masked_dog_filter(img0, 3.5),
            'dog1': masked_dog_filter(img1, 3.5), 'xy0': xy0, 'xy1': xy1,
            'truth': truth, 'c0': np.rint(xy0).astype(np.int64),
            'c1': np.rint(xy1).astype(np.int64)}


def subpixel_compare(case):
    """One launch of the subpixel kernel on ``case`` against its plain
    version on the card. Returns (max abs shift error, kept, the kernel's
    (K, 3) rows); raises where the kept sets differ or a shift is off by
    more than SUBPIXEL_ATOL."""
    import numpy as np
    import torch
    from feabas_tpu_torch.ops import subpixel
    d0, d1, c0, c1 = (case[k] for k in ('dog0', 'dog1', 'c0', 'c1'))
    got = subpixel.subpixel_refine(d0, d1, c0, c1)
    centres = torch.from_numpy(np.concatenate([c0, c1], 1).astype(
        np.int32)).to(d0.device)
    want = subpixel.subpixel_refine_plain(d0, d1, centres)
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    kept = g[:, 2] > 0
    if not np.array_equal(kept, w[:, 2] > 0):
        raise RuntimeError(f'subpixel_refine: the kept sets differ in '
                           f'{int((kept != (w[:, 2] > 0)).sum())} matches')
    err = float(np.abs(g[kept, :2] - w[kept, :2]).max()) if kept.any() \
        else 0.0
    if not err <= SUBPIXEL_ATOL:
        raise RuntimeError(f'subpixel_refine: max abs error {err} px')
    return err, int(kept.sum()), g


def subpixel_bound(k, kept, patch=32, search=6):
    """Bound of one call: each window read once, the centres read and the
    rows written once; per match the means and energies (4 FLOP a window
    value), the correlation (2 FLOP a product) and its maximum, and per
    kept match the 8 steps (11 FLOP a window px: the bilinear sample and
    p1 +- W; 14 an interior px: gradients, products and sums)."""
    n, lags, q = patch + 2 * search, (2 * search + 1) ** 2, patch - 2
    win = n * n + patch * patch
    flop = (k * (4 * win + 2 * lags * patch * patch + lags)
            + kept * 8 * (11 * patch * patch + 14 * q * q))
    return bound(flop, k * (4 * win + 16 + 12))


def check_subpixel(dev):
    """Phase 3, the subpixel refinement's kernel: the cell-sized pair
    (timed: the wrapper call, the kernel's device time from a CUDA-graph
    replay, the plain version, and once the host route it replaces on the
    same thumbnails), windows at every bound of the images, and one
    match."""
    import numpy as np
    import torch
    from feabas_tpu_torch import thumbnail
    from feabas_tpu_torch.ops import subpixel
    case = subpixel_case(dev)
    d0, d1 = case['dog0'], case['dog1']
    h, w = d0.shape
    # the outermost centres whose windows fit: 22 px (16 + the search of 6)
    # from each edge of image 0, 16 px from each edge of image 1
    def bounds(m):
        return np.array([[m, m], [w - m, m], [m, h - m], [w - m, h - m],
                         [m, h // 2], [w // 2, m]])
    rows = []
    for name, c, edge in (
            ('4096^2 sigma 1.5, 1369 matches', case, False),
            ('windows at every bound',
             dict(case, c0=bounds(22), c1=bounds(16)), True),
            ('one match',
             dict(case, c0=case['c0'][:1], c1=case['c1'][:1]), True)):
        err, kept, g = subpixel_compare(c)
        k = c['c0'].shape[0]
        iters, warm = (3, 0.01) if edge else (10, 0.1)
        ms = cuda_time(lambda: subpixel.subpixel_refine(
            d0, d1, c['c0'], c['c1']), iters, warm)
        centres = torch.from_numpy(np.concatenate(
            [c['c0'], c['c1']], 1).astype(np.int32)).to(dev)
        out = torch.empty((k, 3), dtype=torch.float32, device=dev)
        pms = cuda_time(lambda: subpixel.subpixel_refine_plain(
            d0, d1, centres), 3, warm)
        row = kernel_row('subpixel_refine', (k, 32, 6), name, err, ms, pms,
                         subpixel_bound(k, kept))
        row['device_us'] = graph_time(lambda: subpixel.launch(
            d0, d1, centres, out, 32, 6), 5 if edge else 20)
        row['edge'] = edge
        row['kept'] = kept
        rows.append(row)
        if not edge:
            good = g[:, 2] > 0
            xy = c['c0'][good] + g[good, :2] + (c['xy1'][good]
                                                - c['c1'][good])
            truth_err = float(np.median(np.linalg.norm(
                xy - c['truth'][good], axis=1)))
    log_rows(rows)
    # the host route the kernel replaced, on the same thumbnails
    t = time.perf_counter()
    ii, _, _ = thumbnail._subpixel_shifts_host(
        case['img0'].cpu().numpy(), case['img1'].cpu().numpy(), case['c0'],
        case['c1'], 3.5, 32, 6)
    host_ms = (time.perf_counter() - t) * 1e3
    log(f'[kernel] subpixel_refine: {rows[0]["kept"]} of '
        f'{case["c0"].shape[0]} matches kept, median error against the '
        f'truth {truth_err:.4f} px; the host route on the same pair '
        f'{host_ms:.1f} ms, {ii.size} kept')
    rows[0]['host_ms'] = host_ms
    return rows


# phase 6: the thumbnail stack
THUMB_S = 6
THUMB_MIP = 2                         # 2048^2 thumbnails at 16 nm
# degrees of each section, plus a draw of +-THUMB_ROT. The feature stage
# resolves what the JAX package's does: a pair turned by a multiple of one
# variant step (30 degrees), give or take a few degrees, and by less than
# the strain filter's shear_limit of 45 degrees. Every pair of the stack
# (distance 1 and 2) is turned by about 0, +30 or -30 degrees, so both
# halves of the variants win somewhere (+30: variant 1; -30: variant 11)
THUMB_TURNS = (0.0, 30.0, 30.0, 0.0, 0.0, 30.0)
THUMB_ROT = 2.0
THUMB_SHIFT = 200.0                   # translation std, mip0 px at 8192^2


def make_turned_stack(dev, size=SECTION, blur=4.0 * ALIGN_SCALE):
    """THUMB_S sections of size^2 on ``dev``: section z at mip0 pixel p
    shows the seeded base texture at cb + R(angle_z) (p - c) + t_z. Returns
    (sections as host uint8 arrays, angles in degrees, translations)."""
    import numpy as np
    import torch
    from feabas_tpu_torch.ops.warp import bilinear_sample
    rng = np.random.default_rng(SEED + 2)
    angles = rng.uniform(-THUMB_ROT, THUMB_ROT, THUMB_S) \
        + np.asarray(THUMB_TURNS)
    shifts = rng.normal(0, THUMB_SHIFT * size / 8192.0, (THUMB_S, 2))
    n = int(math.ceil(size * math.sqrt(2.0) + 2 * np.abs(shifts).max())) + 16
    base = make_texture(dev, n, n, seed=SEED + 3, blur=blur).to(torch.float32)
    c, cb = (size - 1) / 2.0, (n - 1) / 2.0
    gy, gx = torch.meshgrid(
        torch.arange(size, dtype=torch.float32, device=dev) - c,
        torch.arange(size, dtype=torch.float32, device=dev) - c,
        indexing='ij')
    sections = []
    for z in range(THUMB_S):
        a = math.radians(angles[z])
        ca, sa = math.cos(a), math.sin(a)
        img = bilinear_sample(base, cb + ca * gx - sa * gy + shifts[z][0],
                              cb + sa * gx + ca * gy + shifts[z][1])
        sections.append(torch.round(img).clamp(0, 255).to(torch.uint8)
                        .cpu().numpy())
    return sections, angles, shifts


def _turned_truth(xy1, z0, z1, angles, shifts, size, scale):
    """Where the content at thumbnail px ``xy1`` of section z1 sits in
    section z0 (thumbnail px): R0 (p0 - c) + t0 = R1 (p1 - c) + t1."""
    import numpy as np

    def rot(z):
        a = math.radians(angles[z])
        return np.array([[math.cos(a), -math.sin(a)],
                         [math.sin(a), math.cos(a)]])
    c = (size - 1) / 2.0
    p1 = xy1 * scale + (scale - 1) / 2.0
    q = (p1 - c) @ rot(z1).T + shifts[z1] - shifts[z0]
    p0 = q @ rot(z0) + c
    return (p0 - (scale - 1) / 2.0) / scale


def setup_thumbnail_workdir(root, sections, size):
    """Config dir + work dir holding the stack as stitched sections (tiles
    of at most 4096^2, uncompressed PNG) and the thumbnail overrides; points
    the config system at it."""
    import cv2
    from concurrent.futures import ThreadPoolExecutor
    cfg = os.path.join(root, 'configs')
    shutil.copytree(os.path.join(REPO, 'configs'), cfg)
    wd = os.path.join(root, 'work_dir')
    _save_yaml(os.path.join(cfg, 'general_configs.yaml'), {
        'working_directory': wd, 'parallel_framework': 'serial',
        'full_resolution': 4, 'section_thickness': 30,
        'logfile_level': 'NONE', 'archive_level': 'NONE',
        'console_level': 'WARNING'})
    names = [f't{z:04d}' for z in range(len(sections))]
    tile = min(SECTION_TILE, size)
    jobs = []
    for name, img in zip(names, sections):
        d = os.path.join(wd, 'stitched_sections', 'mip0', name)
        os.makedirs(d)
        lines = ['{ROOT_DIR}\t' + d, '{RESOLUTION}\t4']
        for r in range(0, size, tile):
            for c in range(0, size, tile):
                fn = f'{name}_tr{r // tile + 1}-tc{c // tile + 1}.png'
                jobs.append((os.path.join(d, fn), img[r:r + tile, c:c + tile]))
                lines.append(f'{fn}\t{c}\t{r}\t{c + tile}\t{r + tile}')
        with open(os.path.join(d, 'metadata.txt'), 'w') as f:
            f.write('\n'.join(lines) + '\n')

    def write(job):
        if not cv2.imwrite(job[0], job[1], [cv2.IMWRITE_PNG_COMPRESSION, 0]):
            raise OSError(f'could not write {job[0]}')

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    # the defaults (sigma 3.5, min_spacing 10, 5000 features, 6 x 8
    # descriptors, exhaustive match, compare_distance 2) but for the mip
    # level, one worker and the archived feature-stage matches
    _save_yaml(os.path.join(wd, 'configs', 'thumbnail_configs.yaml'), {
        'thumbnail_mip_level': THUMB_MIP,
        'downsample': {'num_workers': 1},
        'alignment': {'num_workers': 1, 'compare_distance': 2,
                      'save_feature_match': True}})
    os.environ['FEABAS_TPU_CONFIG_DIR'] = cfg
    from feabas_tpu_torch import config
    config.clear_config_caches()
    return wd, names


def _profiled(profile, label, fn):
    """Run ``fn``; with ``profile``, inside one torch.profiler pass whose
    device time by kernel is printed."""
    if not profile:
        return fn()
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    # the hand-written kernels, by the names of their __global__ functions
    own = [e for e in events if any(
        '(anonymous namespace)::' + k in e.key for k in (
            'dog_kernel', 'raster<', 'peak_kernel', 'patch_kernel',
            'prep_kernel', 'variant_max_kernel', 'reduce_kernel<',
            'finish_kernel', 'blend_kernel<', 'operator_kernel<'))]

    def fmt(es):
        return '; '.join(f'{e.key[:48]} {e.self_device_time_total / 1e3:.2f} '
                         f'ms x{e.count}' for e in es)
    log(f'[profile] {label}: device {total / 1e6:.4f} s over '
        f'{sum(e.count for e in events)} device ops; largest: {fmt(top)}; '
        f'hand-written kernels: {fmt(own) or "none"}')
    return out


def run_thumbnail(dev, size=SECTION, profile=False):
    """Phase 6: the turned stack at full size through the thumbnail CLI
    (downsample, then alignment = matching, optimization, render), then
    the CG operator on the systems the path bound it to. Returns
    (launches, launches by shape, stage seconds, the operator's rows)."""
    import numpy as np
    import torch
    from feabas_tpu_torch import aligner, thumbnail
    from feabas_tpu_torch import device as device_mod
    from feabas_tpu_torch.common import imread
    from feabas_tpu_torch.ops import lradon
    from feabas_tpu_torch.scripts import thumbnail_main

    cuda = dev.type == 'cuda'
    t0 = time.perf_counter()
    sections, angles, shifts = make_turned_stack(dev, size)
    root = tempfile.mkdtemp(prefix='feabas_chip_thumb_')
    scale = 2 ** THUMB_MIP
    # observe, without changing them, each pair's first rotation search and
    # the seconds of the three stages that 'alignment' chains
    rots, stage_s = [], {}
    pair_matcher, masked = (thumbnail.match_two_thumbnails_LRadon,
                            lradon.match_lradon_device_masked)
    stages = {k: getattr(thumbnail_main, k)
              for k in ('matching_main', 'optimize_main', 'render_main')}

    def pair_spy(*a, **k):
        rots.append(None)
        return pair_matcher(*a, **k)

    def masked_spy(*a, **k):
        out = masked(*a, **k)
        if rots and rots[-1] is None:
            rots[-1] = out[3]
        return out

    ops = OperatorSpy()

    def timed(key):
        def run(*a, **k):
            ops.stage = key.split('_')[0]
            t = time.perf_counter()
            out = _profiled(profile, f'thumbnail.{key}',
                            lambda: stages[key](*a, **k))
            if cuda:
                torch.cuda.synchronize()
            stage_s[key.split('_')[0]] = time.perf_counter() - t
            return out
        return run

    thumbnail.match_two_thumbnails_LRadon = pair_spy
    lradon.match_lradon_device_masked = masked_spy
    for key in stages:
        setattr(thumbnail_main, key, timed(key))
    ops.__enter__()
    try:
        wd, names = setup_thumbnail_workdir(root, sections, size)
        log(f'[thumbnail] {THUMB_S} sections of {size}x{size} uint8, angles '
            f'{np.round(angles, 1).tolist()} degrees, thumbnails at mip '
            f'{THUMB_MIP} ({size // scale}^2): below highpass_inter_mip_lvl, '
            f'so thumbnail_highpass has nothing to do; set-up '
            f'{time.perf_counter() - t0:.2f} s')
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        device_mod.reset_launch_counts()
        t = time.perf_counter()
        _profiled(profile, 'thumbnail.downsample',
                  lambda: thumbnail_main.main(['--mode', 'downsample']))
        stage_s['downsample'] = time.perf_counter() - t
        thumbnail_main.main(['--mode', 'alignment'])
        launches = device_mod.launch_counts()
        by_shape = device_mod.launch_counts_by_shape()
        ops.__exit__()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        log('[thumbnail] stage seconds ' + json.dumps(
            {k: round(v, 3) for k, v in stage_s.items()})
            + f'; max_memory_allocated {peak} B; launches {launches}')
        pairs = thumbnail_main._pair_list(names, 2, wd)
        res = 4.0 * scale
        if len(rots) != len(pairs) or len(pairs) != 9:
            raise RuntimeError(f'{len(rots)} feature matches for '
                               f'{len(pairs)} pairs')
        f_errs, r_errs, counts, f_counts = [], [], [], []
        for (a, b), rot in zip(pairs, rots):
            z0, z1 = names.index(a), names.index(b)
            for sub, errs in (('feature_matches', f_errs),
                              ('matches', r_errs)):
                path = os.path.join(wd, 'thumbnail_align', sub,
                                    aligner.match_name(a, b))
                if not os.path.exists(path):
                    raise RuntimeError(f'{a} -> {b}: no {sub} file')
                m = aligner.read_matches_from_h5(path, target_resolution=res)
                truth = _turned_truth(m.xy1, z0, z1, angles, shifts, size,
                                      scale)
                errs.append(float(np.median(
                    np.linalg.norm(m.xy0 - truth, axis=-1))))
                (f_counts if sub == 'feature_matches' else counts).append(
                    m.xy0.shape[0])
            # the winning variant turns by rot * 180 / P degrees
            want = (angles[z1] - angles[z0]) % 360.0
            if rot is None or rot != int(round(want / 30.0)) % 12:
                raise RuntimeError(f'{a} -> {b}: best_rot {rot} for a turn '
                                   f'of {want:.1f} degrees')
        log(f'[thumbnail] pairs {[a[-1] + b[-1] for a, b in pairs]}: best_rot '
            f'{rots}, feature matches {f_counts} with median errors '
            f'{np.round(f_errs, 4).tolist()} px, refined matches {counts} '
            f'with median errors {np.round(r_errs, 4).tolist()} px')
        # the JAX package's own bounds: 1.5 px for its unturned and
        # half-turned pairs (tests/test_lradon_device.py:99), 2 px for its
        # pair turned by 30 degrees (tests/test_thumbnail.py:56), whose
        # subpixel refinement correlates patches that are turned too
        turned = [abs((angles[names.index(b)] - angles[names.index(a)]
                       + 180.0) % 360.0 - 180.0) > 15.0 for a, b in pairs]
        if not all(e < (2.0 if t else 1.5) for e, t in zip(f_errs, turned)):
            raise RuntimeError(f'feature matches: median errors {f_errs}')
        if not max(r_errs) < 1.0:
            raise RuntimeError(f'refined matches: median errors {r_errs}')
        aligned = []
        for n in names:
            if not os.path.exists(os.path.join(wd, 'thumbnail_align', 'tform',
                                               n + '.h5')):
                raise RuntimeError(f'no tform for {n}')
            aligned.append(imread(os.path.join(
                wd, 'thumbnail_align', 'aligned', n + '.png'))
                .astype(np.float64))
        h, w = aligned[0].shape
        q = min(h, w) // 4
        inner = (slice(h // 2 - q, h // 2 + q), slice(w // 2 - q, w // 2 + q))
        ccs = []
        for img in aligned[1:]:
            ok = (aligned[0][inner] > 0) & (img[inner] > 0)
            if ok.mean() < 0.5:
                raise RuntimeError('aligned thumbnails do not overlap')
            ccs.append(float(np.corrcoef(aligned[0][inner][ok],
                                         img[inner][ok])[0, 1]))
        if not min(ccs) > 0.9:
            raise RuntimeError(f'aligned thumbnail cc {ccs}, refined match '
                               f'errors {r_errs}')
        if cuda:
            for name in ('dog_filter', 'peak_detect', 'lradon_patch',
                         'lradon_match', 'fem_operator', 'subpixel_refine'):
                if launches[name] <= 0:
                    raise RuntimeError(f'{name} was not launched by the '
                                       'thumbnail path')
        if any(m == 'jax' or m.startswith('jax.') for m in sys.modules):
            raise RuntimeError('jax was imported')
        log(f'[thumbnail] {len(pairs)} of {len(pairs)} pairs matched, worst '
            f'median error of feature matches {max(f_errs):.4f} px and of '
            f'refined matches {max(r_errs):.4f} px, aligned cc '
            f'{min(ccs):.5f}-{max(ccs):.5f}')
        # after the counts were read: these launches compare, not count
        rows = (fem_path_rows(dev, ops.systems, by_shape['fem_operator'],
                              'phase-6', FEM_TIMED) if cuda else [])
        return launches, by_shape, stage_s, rows
    finally:
        ops.__exit__()
        thumbnail.match_two_thumbnails_LRadon = pair_matcher
        lradon.match_lradon_device_masked = masked
        for key, fn in stages.items():
            setattr(thumbnail_main, key, fn)
        shutil.rmtree(root, ignore_errors=True)


VOLUME_THUMB_MIP = 6


def block_reduce(a, f, method='mean'):
    """``a`` reduced over blocks of ``f`` (one factor per axis, blocks from
    index 0): partial edge blocks reduce the entries that are there; an
    integer mean rounds half to even, as tensorstore's downsample does.
    The plain numpy reference of the volume phase's checks."""
    import numpy as np
    f = [int(k) for k in f]
    out = [-(-s // k) for s, k in zip(a.shape, f)]
    pad = [(0, o * k - s) for s, k, o in zip(a.shape, f, out)]
    shape = [v for o, k in zip(out, f) for v in (o, k)]
    axes = tuple(range(1, 2 * a.ndim, 2))
    if method in ('max', 'min'):
        if a.dtype.kind == 'f':
            fill = -np.inf if method == 'max' else np.inf
        else:
            fill = (np.iinfo(a.dtype).min if method == 'max'
                    else np.iinfo(a.dtype).max)
        blocks = np.pad(a, pad, constant_values=fill).reshape(shape)
        return blocks.max(axis=axes) if method == 'max' else \
            blocks.min(axis=axes)
    count = np.ones(out, np.int64)
    for d, (s, k) in enumerate(zip(a.shape, f)):
        n = np.minimum(k, s - np.arange(out[d]) * k)
        count = count * n.reshape([-1 if e == d else 1
                                   for e in range(a.ndim)])
    if a.dtype.kind == 'f':
        total = np.pad(a, pad).reshape(shape).sum(axis=axes,
                                                  dtype=np.float64)
        return (total / count).astype(a.dtype)
    total = np.pad(a, pad).reshape(shape).sum(axis=axes, dtype=np.int64)
    return np.round(total / count).astype(a.dtype)   # half to even


def layer_agreement(got, want):
    """(max |diff|, share of differing pixels, median |diff|, cc) of two
    images of one shape."""
    import numpy as np
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    cc = float(np.corrcoef(got.ravel().astype(np.float64),
                           want.ravel().astype(np.float64))[0, 1])
    return int(d.max()), float((d > 0).mean()), float(np.median(d)), cc


def stitch_volume_outliers(vol, png, off=8, near=4, block=2048):
    """Where the stitch volume and the PNG render differ by more than
    ``off``: how many pixels, how many lie within ``near`` px of an edge
    of the volume's 2048^2 render superblocks, and how many within
    ``near`` px of a pixel that either render left empty (0)."""
    import numpy as np
    import cv2
    bad = np.abs(vol.astype(np.int64) - png.astype(np.int64)) > off
    ys, xs = np.nonzero(bad)
    if not len(ys):
        return f'no pixel off by more than {off}'

    def near_edge(v):
        r = v % block
        return (r < near) | (r >= block - near)
    empty = ((vol == 0) | (png == 0)).astype(np.uint8)
    empty = cv2.dilate(empty, np.ones((2 * near + 1, 2 * near + 1),
                                      np.uint8)) > 0
    return (f'{len(ys)} pixels off by more than {off}: '
            f'{int((near_edge(ys) | near_edge(xs)).sum())} within {near} px '
            f'of a superblock edge, {int(empty[ys, xs].sum())} within {near} '
            f'px of an empty pixel; rows {int(ys.min())}-{int(ys.max())}, '
            f'columns {int(xs.min())}-{int(xs.max())}')


def volume_path_rows(dev, blends, rasters, launched):
    """The montage blend and the mesh raster held bit-equal to their plain
    versions and timed on a copy of the inputs the volume path gave them
    at each shape it launched them with (``FirstOfShape`` calls); fails
    unless those are the shapes the counts list."""
    rows = []
    for key, (a, k, covered) in blends.items():
        if k:
            raise RuntimeError(f'montage_blend called with keywords {k}')
        rows.append(montage_row(
            dev, f'volume superblock {key}',
            {'args': a, 'covered': bool(covered)}, path=True))
    for key, (a, k, covered) in rasters.items():
        if k.get('n_mips', 0):
            raise RuntimeError('mesh_raster emitted mips on the tsr path')
        src, tabs, cands, fillval, h, w, geodesic, out_kind = a
        row, _ = raster_row(dev, f'tsr block batch {key}',
                            (src, tabs, cands, h, w), geodesic, out_kind,
                            fillval, covered.tolist(), iters=10)
        rows.append(row)
    for name, calls in (('montage_blend', blends), ('mesh_raster', rasters)):
        got = sorted('x'.join(map(str, key)) for key in calls)
        if got != sorted(launched[name]):
            raise RuntimeError(f'{name}: inputs kept at shapes {got}, the '
                               f'path launched {sorted(launched[name])}')
    log_rows(rows, ' LSB')
    return rows


def volume_bytes(path):
    """(files, bytes) of the chunk files under ``path``."""
    n = b = 0
    for d, _, fs in os.walk(path):
        for f in fs:
            if f != 'info' and not f.endswith('.json'):
                n += 1
                b += os.path.getsize(os.path.join(d, f))
    return n, b


class WriteCount:
    """Counts the chunk writes ``dal.TensorStoreWriter`` issues (slabs
    and single chunks) while it is entered, without changing them."""

    def __enter__(self):
        from feabas_tpu_torch import dal
        self.cls, self.n = dal.TensorStoreWriter, 0
        self.orig = {k: getattr(self.cls, k)
                     for k in ('write_slab', 'write_single_chunk')}
        for k, fn in self.orig.items():
            def spy(w, *a, _fn=fn, **kw):
                self.n += 1
                return _fn(w, *a, **kw)
            setattr(self.cls, k, spy)
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.cls, k, fn)


def volume_workdir(root, wd, tag, overrides, links=(), copies=()):
    """A work dir for the volume phase beside phase 4's or 5's: a config
    dir naming it, ``copies`` of ``wd``'s subdirs, symlinks to ``links``,
    its override yamls updated with ``overrides`` ({file: {section:
    dict}}); points the config system at it. Returns it."""
    from feabas_tpu_torch import config, storage
    cfg = os.path.join(root, 'configs_' + tag)
    shutil.copytree(os.path.join(root, 'configs'), cfg)
    out = os.path.join(root, 'work_dir_' + tag)
    for sub in ('configs',) + tuple(copies):
        shutil.copytree(os.path.join(wd, sub), os.path.join(out, sub))
    for sub in links:
        os.makedirs(os.path.dirname(os.path.join(out, sub)), exist_ok=True)
        os.symlink(os.path.join(wd, sub), os.path.join(out, sub))
    general = os.path.join(cfg, 'general_configs.yaml')
    _save_yaml(general, dict(storage.load_yaml(general),
                             working_directory=out))
    for fname, sections in overrides.items():
        path = os.path.join(out, 'configs', fname)
        conf = storage.load_yaml(path) if os.path.exists(path) else {}
        for key, vals in sections.items():
            conf[key] = dict(conf.get(key) or {}, **vals)
        _save_yaml(path, conf)
    os.environ['FEABAS_TPU_CONFIG_DIR'] = cfg
    config.clear_config_caches()
    return out


def _stage(stage_s, name, fn, profile=False):
    """``fn()`` timed on the host clock up to a synchronize into
    ``stage_s[name]``; with ``profile`` in one torch.profiler pass."""
    import torch
    t = time.perf_counter()
    out = _profiled(profile, f'volume.{name}', fn)
    torch.cuda.synchronize()
    stage_s[name] = time.perf_counter() - t
    return out


def run_volume(dev, kept, profile=False):
    """Phase 9: the volume output of the stitch and align paths on the
    card, on copies of phase 4's and phase 5's work dirs (``kept``), through
    the port's volume store (``dal.ts``: tensorstore where it is
    installed, else ``_tslite``): (a) the stitch CLI's rendering with a
    neuroglancer_precomputed driver (raw, 256^2 chunks, padded to whole
    chunks) held against phase 4's PNG render; (b) ``align_main --mode
    tsr`` (LINEAR, device rendering, 2048^2 x 64 chunks: one slab) held
    within 1 LSB against phase 5's rendered sections, then again with no
    chunk written; (c) ``align_main --mode tsd`` (mips 1, 3, 5, 7, z
    'auto', the source's raw encoding) with chunks of every scale held
    bit for bit against ``block_reduce`` of the base; (d) the highpass
    thumbnail at mip 6 from (a)'s volume against ``block_reduce``'s
    max-minus-min construction over phase 4's PNG render, and the plain
    one against ``mipmap.create_thumbnail`` of that render. With
    ``profile`` each stage runs in one torch.profiler pass. Returns
    (launches, launches by shape, stage seconds, no rows)."""
    import numpy as np
    from feabas_tpu_torch import dal, mipmap
    from feabas_tpu_torch import device as device_mod
    from feabas_tpu_torch.dal import StaticImageLoader
    from feabas_tpu_torch.ops import montage_render, render
    from feabas_tpu_torch.scripts import align_main, stitch_main
    s_root, s_wd = kept['stitch']
    a_root, a_wd, names = kept['align']
    log(f'[volume] store {dal.ts.__name__}')
    stage_s, by_stage, io = {}, {}, {}
    try:
        device_mod.reset_launch_counts()
        # (a) the stitched section into a volume
        wd = volume_workdir(s_root, s_wd, 'vol', {
            'stitching_configs.yaml': {'rendering': {
                'driver': 'neuroglancer_precomputed'}}},
            copies=('stitch/stitch_coord', 'stitch/tform'))
        # the blend's inputs at each shape the stage launches it with, and
        # the raster's in tsr, as the path gave them
        blends = FirstOfShape(montage_render, 'montage_blend',
                              lambda a: (*a[5].shape, a[3].shape[1]))
        rasters = FirstOfShape(render, 'raster_blocks',
                               lambda a: (a[1].shape[0], a[4], a[5]))
        with WriteCount() as wc, blends:
            _stage(stage_s, 'stitch_volume',
                   lambda: stitch_main.main(['--mode', 'rendering']), profile)
        by_stage['stitch_volume'] = device_mod.launch_counts()
        vol_a = os.path.join(wd, 'stitched_sections', 'mip0', 's0001')
        io['stitch_volume'] = volume_bytes(vol_a) + (wc.n,)
        for name in ('montage_blend', 'gaussian_blur'):
            if by_stage['stitch_volume'][name] <= 0:
                raise RuntimeError(f'{name} was not launched by the stitch '
                                   'volume render')
        ds = dal.ts.open({'driver': 'neuroglancer_precomputed', 'kvstore': {
            'driver': 'file', 'path': vol_a}}).result()
        spec_a = ds.spec().to_json()['scale_metadata']
        vol = ds[..., 0, 0].read().result().T
        from feabas_tpu_torch.stitcher import MontageRenderer
        b = MontageRenderer.from_h5(os.path.join(
            s_wd, 'stitch', 'tform', 's0001.h5')).bounds
        x0, y0 = int(np.floor(b[0])), int(np.floor(b[1]))
        png_dir = os.path.join(s_wd, 'stitched_sections', 'mip0', 's0001')
        png = read_rendered(png_dir, (x0, y0, x0 + vol.shape[1],
                                      y0 + vol.shape[0]))
        mx, share, med, cc = layer_agreement(vol, png)
        log(f'[volume] (a) stitch volume {vol.shape[::-1]} '
            f'({spec_a["encoding"]}, chunks {spec_a["chunk_size"]}) against '
            f'the PNG render: max |diff| {mx}, {share:.6f} of pixels differ, '
            f'median |diff| {med}, cc {cc:.6f}; montage_blend '
            f'{by_stage["stitch_volume"]["montage_blend"]}, gaussian_blur '
            f'{by_stage["stitch_volume"]["gaussian_blur"]} launches; '
            + stitch_volume_outliers(vol, png))
        if not (cc >= 0.99 and med == 0):
            raise RuntimeError(f'stitch volume cc {cc}, median |diff| {med}')

        # (b) the aligned stack into one volume, then resumed
        wd = volume_workdir(a_root, a_wd, 'tsr', {
            'alignment_configs.yaml': {
                'tensorstore_rendering': {'remap_interp': 'LINEAR',
                                          'device_render': True},
                'tensorstore_downsample': {'jpeg_compression': None}}},
            links=('stitched_sections',), copies=('align/tform',))
        before = device_mod.launch_counts()
        with WriteCount() as wc, rasters:
            _stage(stage_s, 'tsr', lambda: align_main.main(['--mode', 'tsr']),
                   profile)
        after = device_mod.launch_counts()
        by_stage['tsr'] = {k: after[k] - before[k] for k in after}
        vol_b = os.path.join(wd, 'aligned_tensorstore')
        io['tsr'] = volume_bytes(vol_b) + (wc.n,)
        if by_stage['tsr']['mesh_raster'] <= 0:
            raise RuntimeError('mesh_raster was not launched by tsr')
        with open(os.path.join(wd, 'align', 'tform', 'canvas.json')) as f:
            canvas = json.load(f)['mip0']
        ds = dal.ts.open({'driver': 'neuroglancer_precomputed', 'kvstore': {
            'driver': 'file', 'path': vol_b}}).result()
        base = ds[..., 0].read().result()
        if base.shape != (canvas[2] - canvas[0], canvas[3] - canvas[1],
                          len(names)):
            raise RuntimeError(f'tsr volume {base.shape} for canvas {canvas}')
        worst, shares = 0, []
        for z, n in enumerate(names):
            ref = StaticImageLoader.from_coordinate_file(os.path.join(
                a_wd, 'aligned_stack', 'mip0', f'{z:05d}_{n}',
                'metadata.txt')).crop(canvas)
            mx, share, _, _ = layer_agreement(base[:, :, z].T, ref)
            worst = max(worst, mx)
            shares.append(share)
        log(f'[volume] (b) tsr {base.shape} against the rendered sections: '
            f'max |diff| {worst}, share differing per z '
            f'{[round(v, 6) for v in shares]}; mesh_raster '
            f'{by_stage["tsr"]["mesh_raster"]} launches, {wc.n} chunk writes')
        if worst > 1:
            raise RuntimeError(f'tsr layer off by {worst} LSB')
        with WriteCount() as wc:
            _stage(stage_s, 'tsr_resume',
                   lambda: align_main.main(['--mode', 'tsr']))
        log(f'[volume] (b) tsr again: {wc.n} chunk writes')
        if wc.n != 0:
            raise RuntimeError(f'resumed tsr wrote {wc.n} chunks')

        # (c) its mip scales
        with WriteCount():
            _stage(stage_s, 'tsd', lambda: align_main.main(['--mode', 'tsd']),
                   profile)
        with open(os.path.join(vol_b, 'info')) as f:
            scales = json.load(f)['scales']
        io['tsd'] = (sum(volume_bytes(os.path.join(vol_b, sc['key']))[0]
                         for sc in scales[1:]),
                     sum(volume_bytes(os.path.join(vol_b, sc['key']))[1]
                         for sc in scales[1:]), None)
        if len(scales) != 5:
            raise RuntimeError(f'{len(scales)} scales in info: '
                               f'{[sc["key"] for sc in scales]}')
        checked = []
        for i, sc in enumerate(scales[1:], start=1):
            f = [int(round(r / r0)) for r, r0 in zip(sc['resolution'],
                                                     scales[0]['resolution'])]
            ds = dal.ts.open({'driver': 'neuroglancer_precomputed',
                              'scale_index': i, 'kvstore': {
                                  'driver': 'file', 'path': vol_b}}).result()
            size, ch = sc['size'], sc['chunk_sizes'][0]
            corners = {(0, 0), (((size[0] - 1) // ch[0]) * ch[0],
                                ((size[1] - 1) // ch[1]) * ch[1]),
                       ((size[0] // 2 // ch[0]) * ch[0], 0)}
            for cx, cy in sorted(corners):
                cx1, cy1 = min(cx + ch[0], size[0]), min(cy + ch[1], size[1])
                got = ds[cx:cx1, cy:cy1, :, 0].read().result()
                want = block_reduce(
                    base[cx * f[0]:cx1 * f[0], cy * f[1]:cy1 * f[1]], f)
                if not np.array_equal(got, want):
                    raise RuntimeError(f'scale {sc["key"]} chunk at '
                                       f'({cx}, {cy}) differs from the mean '
                                       'of the base')
                checked.append(f'{sc["key"]}@{cx},{cy}')
        log(f'[volume] (c) tsd scales {[sc["key"] for sc in scales]}; '
            f'{len(checked)} chunks bit-equal to block_reduce of the base: '
            f'{checked}')

        # (d) thumbnails straight from (a)'s volume
        import cv2
        thumb = _stage(stage_s, 'thumbnail',
                       lambda: mipmap.create_thumbnail_tensorstore(
                           vol_a, None, thumbnail_mip=VOLUME_THUMB_MIP,
                           highpass=True))
        inter = VOLUME_THUMB_MIP - 2
        m = block_reduce(png, (2 ** inter, 2 ** inter))
        hp = (block_reduce(block_reduce(m, (2, 2), 'max').astype(
            np.float32), (2, 2)) - block_reduce(block_reduce(
                m, (2, 2), 'min').astype(np.float32), (2, 2)))
        h, w = min(thumb.shape[0], hp.shape[0]), min(thumb.shape[1],
                                                    hp.shape[1])
        cc_hp = float(np.corrcoef(thumb[:h, :w].ravel().astype(np.float64),
                                  -hp[:h, :w].ravel().astype(np.float64))[0, 1])
        plain = mipmap.create_thumbnail_tensorstore(
            vol_a, None, thumbnail_mip=VOLUME_THUMB_MIP, highpass=False)
        ref_png = os.path.join(a_root, 'thumb_ref.png')
        mipmap.create_thumbnail(os.path.join(png_dir, 'metadata.txt'),
                                ref_png, thumbnail_mip=VOLUME_THUMB_MIP,
                                highpass=False)
        ref = cv2.imread(ref_png, cv2.IMREAD_GRAYSCALE)
        s = 2 ** VOLUME_THUMB_MIP
        h, w = (int(b[3]) - y0) // s, (int(b[2]) - x0) // s

        def cc_over_section(a, c):
            return float(np.corrcoef(a[:h, :w].ravel().astype(np.float64),
                                     c[:h, :w].ravel().astype(np.float64))[
                                         0, 1])
        cc_plain = cc_over_section(plain, ref)
        # told, not checked: the image path's highpass is another filter
        # (mid - blur(mid)), not the volume path's max - min
        os.remove(ref_png)
        mipmap.create_thumbnail(os.path.join(png_dir, 'metadata.txt'),
                                ref_png, thumbnail_mip=VOLUME_THUMB_MIP,
                                highpass=True)
        cc_image_hp = cc_over_section(
            thumb, cv2.imread(ref_png, cv2.IMREAD_GRAYSCALE))
        log(f'[volume] (d) mip-{VOLUME_THUMB_MIP} thumbnails from the '
            f'volume: highpass {thumb.shape} against the max-minus-min of '
            f'the PNG render {hp.shape}: cc {cc_hp:.6f}; plain {plain.shape} '
            f'against create_thumbnail of the PNG render {ref.shape} over '
            f'the section ({h}, {w}): cc {cc_plain:.6f}; (the highpass '
            f'against the image path\'s highpass thumbnail: cc '
            f'{cc_image_hp:.6f}, another filter)')
        if not (cc_hp > 0.9 and cc_plain > 0.9):
            raise RuntimeError(f'thumbnail cc {cc_hp}, {cc_plain}')
        launches = device_mod.launch_counts()
        by_shape = device_mod.launch_counts_by_shape()
        rates = {k: {'chunks': n, 'MB': round(nb / 1e6, 3),
                     'MB_per_s': round(nb / 1e6 / stage_s[k], 3),
                     'writes': wr} for k, (n, nb, wr) in io.items()}
        log('[volume] stage seconds ' + json.dumps(
            {k: round(v, 3) for k, v in stage_s.items()})
            + '; written ' + json.dumps(rates) + f'; launches {launches}')
        if any(m_ == 'jax' or m_.startswith('jax.') for m_ in sys.modules):
            raise RuntimeError('jax was imported')
        # after the counts were read: these launches compare, not count
        return launches, by_shape, stage_s, volume_path_rows(
            dev, blends.calls, rasters.calls, by_shape)
    finally:
        shutil.rmtree(s_root, ignore_errors=True)
        shutil.rmtree(a_root, ignore_errors=True)


PHASES = ('kernels', 'stitch', 'align', 'chunked', 'thumbnail', 'nonlinear',
          'volume')


def parse_args(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--phases', default=','.join(PHASES),
                   help='comma list of ' + ', '.join(PHASES))
    p.add_argument('--profile', action='store_true',
                   help='one torch.profiler pass per stitch, thumbnail and '
                   'volume stage')
    args = p.parse_args(argv)
    args.phases = [x for x in args.phases.split(',') if x]
    if set(args.phases) - set(PHASES):
        p.error(f'unknown phase in {args.phases}')
    if 'chunked' in args.phases and 'align' not in args.phases:
        p.error('the chunked phase runs on the align phase\'s work dir')
    if 'volume' in args.phases and not {'stitch', 'align'} <= set(
            args.phases):
        p.error('the volume phase runs on the stitch and align phases\' '
                'work dirs')
    return args


def main(argv=None):
    import torch
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from feabas_tpu_torch import build
    from feabas_tpu_torch import device as device_mod
    os.environ[device_mod.DEVICE_ENV] = 'cuda'
    dev = device_mod.get_device('cuda')
    card = card_line()
    log(f'[card] {card}; torch {torch.__version__}; CUDA {torch.version.cuda}; '
        f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')
    from concurrent.futures import ThreadPoolExecutor
    t = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(build.build, KERNEL_SOURCES))
    log(f'[build] {", ".join(os.path.relpath(l, REPO) for l in libs)} in '
        f'{time.perf_counter() - t:.2f} s')
    rows = []
    if 'kernels' in args.phases:
        rows += check_kernels(dev)
        rows += check_raster(dev, make_texture(dev, 8192, 8192).cpu().numpy())
        rows += check_montage(dev)
        rows += check_lradon(dev)
        rows += check_fem(dev)
        rows += check_subpixel(dev)
    # phase 9 works on copies of phase 4's and phase 5's work dirs
    kept = {} if 'volume' in args.phases else None
    paths = {'stitch': lambda d: run_slice(d, profile=args.profile,
                                           keep=kept),
             'align': lambda d: run_align(d, 'chunked' in args.phases,
                                          keep=kept),
             'thumbnail': lambda d: run_thumbnail(d, profile=args.profile),
             'nonlinear': run_nonlinear,
             'volume': lambda d: run_volume(d, kept, profile=args.profile)}
    runs = {}
    try:
        for p, fn in paths.items():
            if p in args.phases:
                runs[p] = fn(dev)
                if p == 'align':
                    runs[p], chunked = runs[p][:4], runs[p][4]
                    if chunked is not None:
                        runs['chunked'] = chunked
    finally:
        for kept_dir in (kept or {}).values():
            shutil.rmtree(kept_dir[0], ignore_errors=True)
    for r in runs.values():
        rows += r[3]
    log_determinism()
    if set(args.phases) != set(PHASES):
        for path, r in runs.items():
            log(f'[{path}] launches by shape ' + json.dumps(r[1]))
        log(f'chip_smoke: ran only {args.phases}')
        log(card)
        return 0
    entries = []
    for n, (src, replaces) in KERNELS.items():
        checks = [r for r in rows if r['name'] == n]
        # the headline row: the checked shape the paths launched most, ties
        # broken by the device time those launches took
        shape_launches = {}
        for r in runs.values():
            for k, c in r[1][n].items():
                shape_launches[k] = shape_launches.get(k, 0) + c
        main_row = max((r for r in checks if not r.get('edge')), key=lambda r: (
            shape_launches.get('x'.join(map(str, r['shape'])), 0),
            shape_launches.get('x'.join(map(str, r['shape'])), 0) * r['ms']))
        entries.append({
            'name': n, 'route': 'cuda',
            'source': f'feabas_tpu_torch/csrc/{src}.cu', 'replaces': replaces,
            'launches': sum(int(r[0][n]) for r in runs.values()),
            'launches_by_path': {p: int(r[0][n]) for p, r in runs.items()},
            'launches_by_shape': {p: r[1][n] for p, r in runs.items()},
            'max_abs_err': max(r['max_abs_err'] for r in checks),
            'shape': main_row['shape'], 'what': main_row['what'],
            'ms': main_row['ms'], 'plain_ms': main_row['plain_ms'],
            'bound_ms': main_row['bound_us'] / 1e3,
            'bound_us': main_row['bound_us'],
            'bound_by': main_row['bound_by'],
            # the DoG and blur's: a replicate pad and two conv2d
            # (blur_library); the raster and the montage blend have none:
            # nothing in PyTorch rasterizes a mesh
            'library_ms': main_row['library_ms'],
            'checks': [{k: r[k] for k in (
                'shape', 'what', 'max_abs_err', 'ms', 'plain_ms', 'bound_us',
                'bound_by', 'library_ms', 'close_rows', 'device_us', 'K',
                'real_per_cell', 'kept_per_tile', 'kept_rows_per_cell',
                'covered_per_px', 'form', 'form_device_us', 'registers',
                'local_bytes', 'blocks_per_sm', 'kept', 'host_ms')
                if k in r}
                for r in checks]})
    log(json.dumps({'kernels': entries}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
