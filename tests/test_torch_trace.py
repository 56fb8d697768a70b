"""The port's spans and counters (``feabas_tpu_torch/trace.py``): ranges on
the profiler's clock, host counters where the work happens, the launch
counters behind ``device``'s views, and ``stage_timer``'s log line."""

import ast
import logging
import math
import os
import sys
import threading

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from feabas_tpu_torch import common, dal, trace
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch.logging import stage_timer
from feabas_tpu_torch.ops import fem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    trace.reset_counters()
    yield
    trace.reset_counters()


def _ranges(prof):
    """{name: [(start_ns, end_ns, is_user_annotation)]} of the session's
    ``feabas.*`` host ranges."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            out.setdefault(e.name()[len(trace.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(),
                 e.is_user_annotation()))
    return out


def test_spans_nest_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span('outer'):
            with trace.span('inner'):
                torch.ones(8).sum()
    got = _ranges(prof)
    (o0, o1, o_user), = got['outer']
    (i0, i1, i_user), = got['inner']
    assert o0 <= i0 <= i1 <= o1
    # function-scope records: no copy of the range on a device's timeline
    assert not o_user and not i_user


def test_a_span_records_nothing_without_a_profiler():
    with trace.span('unseen'):
        torch.ones(8).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
    assert _ranges(prof) == {}
    assert trace.counters() == {}


@pytest.mark.parametrize('shape', [(37, 53), (21, 30, 3)])
def test_imread_counts_one_decode_and_its_pixels(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 255, shape, dtype=np.uint8)
    path = str(tmp_path / 'a.png')
    common.imwrite(path, img)
    assert trace.counters() == {'blender.encodes': 1}
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = common.imread(path)
    np.testing.assert_array_equal(got, img)
    assert trace.counters() == {'loader.decodes': 1,
                                'loader.decoded_px': shape[0] * shape[1]}
    assert len(_ranges(prof)['loader.decode']) == 1
    assert common.imread(str(tmp_path / 'missing.png')) is None
    assert trace.counters()['loader.decodes'] == 1


def test_imwrite_opens_the_encode_span(tmp_path):
    img = np.zeros((16, 24), np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        common.imwrite(str(tmp_path / 'b.png'), img)
    assert len(_ranges(prof)['blender.encode']) == 1
    assert 'loader.decode' not in _ranges(prof)
    assert trace.counters()['blender.encodes'] == 1


def _tile_loader(tmp_path, **kwargs):
    img = np.arange(64 * 96, dtype=np.uint16).reshape(64, 96).astype(np.uint8)
    path = str(tmp_path / 't.png')
    cv2.imwrite(path, img)
    return dal.StaticImageLoader([path], [(0, 0, 96, 64)], dtype='uint8',
                                 number_of_channels=1, **kwargs), img


def test_loader_cache_counts_one_hit_of_two_lookups(tmp_path):
    loader, img = _tile_loader(tmp_path, cache_size=4)
    a = loader.crop((10, 5, 40, 30))
    b = loader.crop((10, 5, 40, 30))
    np.testing.assert_array_equal(a, img[5:30, 10:40])
    np.testing.assert_array_equal(a, b)
    c = trace.counters()
    assert (c['loader.cache_lookups'], c['loader.cache_hits']) == (2, 1)
    assert c['loader.decodes'] == 1


def test_loader_without_a_cache_counts_lookups_and_no_hit(tmp_path):
    loader, _ = _tile_loader(tmp_path)
    loader.crop((0, 0, 20, 20))
    loader.crop((0, 0, 20, 20))
    c = trace.counters()
    assert c['loader.cache_lookups'] == 2 and 'loader.cache_hits' not in c
    assert c['loader.decodes'] == 2


def test_border_band_gets_are_lookups(tmp_path):
    loader, img = _tile_loader(tmp_path, cache_size=16, cache_border_margin=8)
    first = loader.crop((0, 0, 96, 6))         # inside the top band
    again = loader.crop((0, 0, 96, 6))
    np.testing.assert_array_equal(first, img[:6])
    np.testing.assert_array_equal(again, first)
    c = trace.counters()
    # four band gets a crop; the first finds none, the second all four
    assert (c['loader.cache_lookups'], c['loader.cache_hits']) == (8, 4)
    assert c['loader.decodes'] == 1


def _cg_before(matvec, b, diag, tol, maxiter):
    """``fem.cg_solve`` as it was before it counted (batched form, no
    ``chances``, the Jacobi preconditioner): the reference of the bits."""
    x0 = torch.zeros_like(b)
    ok = diag > 1e-12
    minv = torch.where(ok, 1.0 / torch.where(ok, diag, 1.0), 1.0)

    def dot(a, c):
        return (a * c).sum(dim=(1, 2))

    bnorm = torch.sqrt(dot(b, b))
    limit = torch.clamp(tol * bnorm, min=0.0)
    max_stall = maxiter + 1
    r = b - matvec(x0)
    z = minv * r
    p = z
    rz = dot(r, z)
    x = best_x = x0
    best_rn = rn = torch.sqrt(dot(r, r))
    it = torch.zeros(b.shape[0], dtype=torch.int64)
    stall = torch.zeros_like(it)
    for k in range(int(maxiter)):
        active = (it < maxiter) & (rn > limit) & (stall <= max_stall)
        if k % 8 == 0 and not bool(active.any()):
            break
        a3 = active[:, None, None]
        Ap = matvec(p)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
        x_new = x + alpha[:, None, None] * p
        r_new = r - alpha[:, None, None] * Ap
        z = minv * r_new
        rz_new = dot(r_new, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        p_new = z + beta[:, None, None] * p
        rn_new = torch.sqrt(dot(r_new, r_new))
        improved = (rn_new < best_rn) & active
        best_x = torch.where(improved[:, None, None], x_new, best_x)
        best_rn = torch.where(improved, rn_new, best_rn)
        stall = torch.where(active, torch.where(improved, 0, stall + 1), stall)
        x = torch.where(a3, x_new, x)
        r = torch.where(a3, r_new, r)
        p = torch.where(a3, p_new, p)
        rz = torch.where(active, rz_new, rz)
        rn = torch.where(active, rn_new, rn)
        it = it + active.to(it.dtype)
    return best_x, it, best_rn


@pytest.mark.parametrize('systems, maxiter', [(1, 500), (3, 500), (3, 5)])
def test_cg_solve_counts_its_trips_and_keeps_its_bits(systems, maxiter):
    g = torch.Generator().manual_seed(systems)
    nv = 40
    a = torch.randn((systems, nv, nv), generator=g, dtype=torch.float64)
    # SPD systems of different condition, so they stop at different trips
    spd = a @ a.transpose(1, 2) + torch.arange(1, systems + 1,
                                               dtype=torch.float64)[:, None, None] \
        * nv * torch.eye(nv, dtype=torch.float64)
    b = torch.randn((systems, nv, 2), generator=g, dtype=torch.float64)
    diag = torch.diagonal(spd, dim1=1, dim2=2)[..., None].expand(-1, -1, 2)

    def matvec(v):
        return spd @ v
    want = _cg_before(matvec, b, diag, 1e-10, maxiter)
    if systems == 1:
        got = fem.cg_solve(lambda v: spd[0] @ v, b[0], diag=diag[0], tol=1e-10,
                           maxiter=maxiter)
        got = tuple(v[None] for v in got)
    else:
        got = fem.cg_solve(matvec, b, diag=diag, tol=1e-10, maxiter=maxiter)
    for u, v in zip(got, want):
        assert torch.equal(u, v)
    its = int(got[1].max())
    trips = min(maxiter, 8 * math.ceil(its / 8))
    assert trace.counters() == {'solver.cg_calls': 1, 'solver.cg_iters': trips}


def test_launch_counters_are_views_of_the_trace_counters():
    device_mod.reset_launch_counts()
    assert device_mod.launch_counts() == {k: 0 for k in device_mod.KERNELS}
    assert device_mod.launch_counts_by_shape() == {k: {} for k in device_mod.KERNELS}
    device_mod.count_launch('montage_blend', (4096, 4, 146))
    device_mod.count_launch('montage_blend', (4096, 4, 146))
    device_mod.count_launch('fem_operator')
    counts = device_mod.launch_counts()
    assert list(counts) == list(device_mod.KERNELS)
    assert counts['montage_blend'] == 2 and counts['fem_operator'] == 1
    assert sum(counts.values()) == 3
    by = device_mod.launch_counts_by_shape()
    assert by['montage_blend'] == {'4096x4x146': 2}
    assert by['fem_operator'] == {'?': 1} and by['dog_filter'] == {}
    assert trace.counters() == {'launch.montage_blend': 2,
                                'launch.fem_operator': 1}
    with pytest.raises(KeyError):
        device_mod.count_launch('no_such_kernel')
    device_mod.reset_launch_counts()
    assert device_mod.launch_counts() == {k: 0 for k in device_mod.KERNELS}
    assert device_mod.launch_counts_by_shape()['montage_blend'] == {}


def test_stage_timer_logs_its_line_and_opens_a_span(caplog):
    logger = logging.getLogger('feabas_trace_test')
    with caplog.at_level(logging.INFO, logger='feabas_trace_test'):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with stage_timer(logger, 'align.matching', section='s0001'):
                torch.ones(4).sum()
            with pytest.raises(ValueError):
                with stage_timer(logger, 'align.rendering'):
                    raise ValueError('bad tile')
            with stage_timer(None, 'align.matching.pair') as t:
                assert t.elapsed >= 0.0
    msgs = [(r.levelno, r.getMessage()) for r in caplog.records]
    assert len(msgs) == 2
    assert msgs[0][0] == logging.INFO
    assert msgs[0][1].startswith('align.matching [section=s0001]: ')
    assert msgs[0][1].endswith('s')
    float(msgs[0][1].split(': ')[1][:-1])
    assert msgs[1][0] == logging.ERROR
    assert msgs[1][1].startswith('align.rendering: FAILED after ')
    assert msgs[1][1].endswith('s (ValueError: bad tile)')
    got = _ranges(prof)
    assert {k: len(v) for k, v in got.items()} == {
        'align.matching': 1, 'align.rendering': 1, 'align.matching.pair': 1}


def test_counting_from_many_threads_loses_nothing():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                trace.count('t.n')
                trace.count('t.px', 3)
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert trace.counters() == {'t.n': 32000, 't.px': 96000}


def test_the_cli_drivers_time_their_units_with_stage_timer():
    """No ``time.time()`` timer is left in the three drivers: each
    per-section or per-pair line is timed by a ``stage_timer`` span."""
    for name in ('align_main', 'stitch_main', 'thumbnail_main'):
        path = os.path.join(REPO, 'feabas_tpu_torch', 'scripts', name + '.py')
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
        clocks = [n for n in calls if isinstance(n.func, ast.Attribute)
                  and n.func.attr == 'time'
                  and isinstance(n.func.value, ast.Name)
                  and n.func.value.id == 'time']
        timers = [n for n in calls if isinstance(n.func, ast.Name)
                  and n.func.id == 'stage_timer']
        assert not clocks, name
        assert len(timers) >= 3, name


def _stitch_workdir(root, tiles, stage_bboxes):
    """A config dir and work dir holding one section of ``tiles``, written
    with the port's own storage and image IO; returns the config dir."""
    import shutil
    from feabas_tpu_torch import storage
    cfg = os.path.join(root, 'configs')
    shutil.copytree(os.path.join(REPO, 'configs'), cfg)
    wd = os.path.join(root, 'work_dir')
    storage.save_yaml(os.path.join(cfg, 'general_configs.yaml'), {
        'working_directory': wd, 'parallel_framework': 'serial',
        'full_resolution': 4, 'section_thickness': 30,
        'logfile_level': 'NONE', 'archive_level': 'NONE',
        'console_level': 'WARNING', 'cpu_budget': 2})
    tdir = os.path.join(wd, 'raw', 's0001')
    lines = ['{ROOT_DIR}\t' + tdir, '{RESOLUTION}\t4']
    for k, (tile, sb) in enumerate(zip(tiles, stage_bboxes)):
        fn = f'tile_{k:03d}.png'
        common.imwrite(os.path.join(tdir, fn), tile)
        lines.append(f'{fn}\t{sb[0]:.0f}\t{sb[1]:.0f}\t{sb[2]:.0f}\t{sb[3]:.0f}')
    with storage.File(os.path.join(wd, 'stitch', 'stitch_coord', 's0001.txt'),
                      'w') as f:
        f.write('\n'.join(lines) + '\n')
    storage.save_yaml(os.path.join(wd, 'configs', 'stitching_configs.yaml'), {
        'matching': {'matcher_config': {'coarse_downsample': 1.0,
                                        'conf_thresh': 0.25}},
        'rendering': {'loader_settings': {'apply_CLAHE': False,
                                          'inverse': False}}})
    return cfg, wd


def test_a_stitch_run_records_its_spans_and_counters(tmp_path, monkeypatch):
    """One small section through the port's stitch CLI under a CPU
    profiler: the driver's stage and section spans, the decode, encode and
    H5 spans, and the decode, cache and CG counters."""
    from synthutil import tile_grid
    from feabas_tpu_torch import config
    from feabas_tpu_torch.scripts import stitch_main
    torch.set_num_threads(1)
    rng = np.random.default_rng(7)
    _, tiles, _, stage_bb = tile_grid(rng, rows=1, cols=2, tile_h=200,
                                      tile_w=300, overlap=120, jitter=2.0)
    cfg, wd = _stitch_workdir(str(tmp_path), tiles, stage_bb)
    monkeypatch.setenv('FEABAS_TPU_CONFIG_DIR', cfg)
    config.clear_config_caches()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for mode in ('matching', 'optimization', 'rendering'):
                stitch_main.main(['--mode', mode])
    finally:
        config.clear_config_caches()
    assert os.path.exists(os.path.join(wd, 'stitched_sections', 'mip0',
                                       's0001', 'metadata.txt'))
    got = _ranges(prof)
    for name in ('stitch.matching', 'stitch.optimization', 'stitch.rendering',
                 'stitch.matching.section', 'stitch.optimization.section',
                 'stitch.rendering.section', 'io.h5', 'loader.decode',
                 'blender.encode'):
        assert name in got, (name, sorted(got))
    (m0, m1, _), = got['stitch.matching']
    (s0, s1, _), = got['stitch.matching.section']
    assert m0 <= s0 <= s1 <= m1
    c = trace.counters()
    assert c['loader.decodes'] >= 2
    assert c['loader.decoded_px'] >= 2 * 200 * 300
    assert c['loader.cache_lookups'] >= 2
    assert c['solver.cg_calls'] >= 1
    assert c['solver.cg_iters'] >= c['solver.cg_calls']


def _written(wd):
    """{path under the work dir: contents} of what the stitch CLI wrote:
    the bytes of each file, and of an H5 file its datasets and
    attributes, since HDF5 stamps each object with its write time."""
    import h5py
    files = {}
    for sub in ('stitch', 'stitched_sections'):
        top = os.path.join(wd, sub)
        for d, _, fns in os.walk(top):
            for fn in fns:
                path = os.path.join(d, fn)
                key = os.path.relpath(path, top)
                if fn.endswith('.h5'):
                    got = files[key] = {}

                    def take(n, o, got=got):
                        if isinstance(o, h5py.Dataset):
                            got[n] = o[()]
                        got.update({f'{n}@{a}': v for a, v in o.attrs.items()})
                    with h5py.File(path, 'r') as f:
                        take('', f)
                        f.visititems(take)
                else:
                    with open(path, 'rb') as f:
                        files[key] = f.read()
    return files


def test_a_stitch_run_reads_its_first_tiles_header_not_the_tile(
        tmp_path, monkeypatch):
    """The same small section through the stitch CLI twice: as shipped,
    and with the header read off, so that each loader built decodes its
    first tile for its dtype. The shipped run decodes exactly the
    matcher's and the blender's probe tile less, and both write the same
    files, in the same place."""
    import shutil
    from synthutil import tile_grid
    from feabas_tpu_torch import config
    from feabas_tpu_torch.scripts import stitch_main
    torch.set_num_threads(1)
    rng = np.random.default_rng(7)
    _, tiles, _, stage_bb = tile_grid(rng, rows=1, cols=2, tile_h=200,
                                      tile_w=300, overlap=120, jitter=2.0)
    runs = {}
    for name in ('shipped', 'decode_probe'):
        shutil.rmtree(tmp_path / 'run', ignore_errors=True)
        cfg, wd = _stitch_workdir(str(tmp_path / 'run'), tiles, stage_bb)
        monkeypatch.setenv('FEABAS_TPU_CONFIG_DIR', cfg)
        config.clear_config_caches()
        trace.reset_counters()
        try:
            with monkeypatch.context() as m:
                if name == 'decode_probe':
                    m.setattr(common, 'image_meta', lambda path: None)
                for mode in ('matching', 'optimization', 'rendering'):
                    stitch_main.main(['--mode', mode])
        finally:
            config.clear_config_caches()
        runs[name] = (trace.counters(), _written(wd))
    (c, files), (c_probe, files_probe) = runs['shipped'], runs['decode_probe']
    assert c['loader.meta_headers'] == 2
    assert 'loader.meta_decodes' not in c
    assert 'loader.meta_headers' not in c_probe
    assert c_probe['loader.meta_decodes'] == 2
    assert c['loader.decodes'] == c_probe['loader.decodes'] - 2
    assert c['loader.decoded_px'] == c_probe['loader.decoded_px'] - 2 * 200 * 300
    assert any(k.endswith('.png') for k in files)
    assert sorted(files) == sorted(files_probe)
    for k, got in files.items():
        if not k.endswith('.h5'):
            assert got == files_probe[k], k
            continue
        assert sorted(got) == sorted(files_probe[k]), k
        assert got
        for n, v in got.items():
            np.testing.assert_array_equal(v, files_probe[k][n],
                                          err_msg=f'{k}:{n}')


@pytest.mark.cuda
def test_spans_leave_no_range_on_the_device_timeline():
    """On the card: a span around kernel launches lands on the host side
    only, so a reader of the device events counts no range as device
    work (a ``record_function`` range would get a copy there)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    x = torch.ones(1 << 16, device='cuda')
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.span('on_card'):
            y = x * 2 + 1
            y = y * 2 + 1
        torch.cuda.synchronize()
    dev = [e.name() for e in prof.profiler.kineto_results.events()
           if 'CPU' not in str(e.device_type())]
    host = [e.name() for e in prof.profiler.kineto_results.events()
            if 'CPU' in str(e.device_type())]
    assert 'feabas.on_card' in host
    assert not [n for n in dev if n.startswith(trace.PREFIX)]
    assert sum(1 for n in dev if not n.startswith('feabas.')) >= 4


@pytest.mark.cuda
def test_a_kernel_launched_from_c_keeps_a_host_event_at_its_launch():
    """On the card: the CG operator's kernel, launched through
    ``device.launch_on`` inside an outer span and a caller's range (as
    the benchmark's kernel ranges wrap it), is linked to the ``launch``
    span, which starts inside the caller's range, not to the outer span."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    sys.path.insert(0, REPO)
    import chip_smoke
    dev = torch.device('cuda')
    args = chip_smoke.round_case(dev)
    rs, w = args[5], args[8]
    P, V = args[0].shape[:2]
    x = torch.randn((P * V, 2), device=dev)
    op = fem.bind_elastic_operator(
        args[2].contiguous(), dict(rs['tables'], group=8),
        w.reshape(-1).contiguous(), torch.ones((P * V, 1), device=dev),
        1.0, 1.0)
    op(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.span('outer'):
            with torch.profiler.record_function('caller'):
                op(x)
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = {}
    for e in events:
        if 'CPU' in str(e.device_type()):
            host.setdefault(e.correlation_id(), []).append(e)
    caller, = [e for e in events if e.name() == 'caller'
               and 'CPU' in str(e.device_type())]
    kernels = [e for e in events if 'CPU' not in str(e.device_type())
               and 'operator_kernel' in e.name()]
    assert kernels, sorted({e.name()[:60] for e in events})
    for k in kernels:
        linked = host.get(k.linked_correlation_id(), [])
        ours = [h for h in linked if h.name().startswith(trace.PREFIX)]
        assert [h.name() for h in ours] == [trace.PREFIX + 'launch'], \
            [h.name() for h in linked]
        assert caller.start_ns() <= ours[0].start_ns() \
            <= caller.start_ns() + caller.duration_ns()
