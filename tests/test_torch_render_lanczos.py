"""The mesh raster's Lanczos-4 mode (``ops/render.py``, ``renderer.py``) on
the CPU: the plain raster against ``cv2.remap(INTER_LANCZOS4,
BORDER_CONSTANT)`` at the raster's own coordinates, the plain path against
the benchmark's plain reference (``bench_port/reference/render.py``), the
card route of ``MeshRenderer.crop`` against its host route, ``VolumeRenderer``
at LANCZOS taking the card route, LINEAR output bytes as they were before
the Lanczos mode, and the renderer's spans and counters. The card case
(``cuda``) holds the kernel's crop bit-equal to the plain one. No JAX here:
the file runs on the card as it is."""

import hashlib
import os
import sys

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from feabas_tpu_torch import _tslite
from feabas_tpu_torch import config as pconfig
from feabas_tpu_torch import dal as pdal
from feabas_tpu_torch import renderer as prenderer
from feabas_tpu_torch import trace
from feabas_tpu_torch.dal import StreamLoader
from feabas_tpu_torch.mesh import Mesh
from feabas_tpu_torch.ops import render
from feabas_tpu_torch.renderer import MeshRenderer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'bench_port'))

from reference import render as reference  # noqa: E402

# the tier-1 run shares the cores among several pytest workers
torch.set_num_threads(1)

LANCZOS = cv2.INTER_LANCZOS4

# What cv2.remap's Lanczos-4 gives at the same coordinates. The port sums
# the 64 taps in f32, cv2 sums u8 taps with 15-bit fixed-point weights and
# u16 taps in f32 in another order: a sum that lands near a half rounds the
# other way, so integer outputs differ by at most 1 LSB, on a few pixels in
# a thousand (measured 0.2-0.3%); f32 outputs by the rounding of 64 terms
# of up to ~300 (f32 ulp 3e-5; measured 2e-4).
INT_LSB, INT_SHARE, F32_ABS = 1, 0.01, 2e-3


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU, asked for by name; the port's config caches start and end
    empty."""
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


def _texture(n, seed=5):
    """σ 1.5 px texture, mean 128, std 40 (the render cell's)."""
    from scipy.ndimage import gaussian_filter
    w = gaussian_filter(np.random.default_rng(seed).normal(0, 1, (n, n)), 1.5)
    return (w / w.std() * 40 + 128).clip(0, 255).astype(np.uint8)


def _source(kind, n=512):
    img = _texture(n)
    if kind == 'u16':
        noise = np.random.default_rng(1).integers(0, 256, img.shape)
        return (img.astype(np.uint16) * 256 + noise).astype(np.uint16)
    if kind == 'f32':
        return (img.astype(np.float32) - 100.0) * 1.75
    return img


def _mesh(n=512, mesh_size=64, amp=4.0, shift=(0.0, 0.0)):
    """A cartesian mesh over (0, 0, n, n) (128 triangles at the defaults),
    its MOVING gear warped smoothly by ``amp`` px and shifted."""
    m = Mesh.from_bbox((0, 0, n, n), cartesian=True, mesh_size=mesh_size,
                       resolution=4)
    v = m.vertices_w_offset('INITIAL')
    d = np.stack([amp * np.sin(v[:, 1] / 97), amp * np.cos(v[:, 0] / 83)], -1)
    m.set_vertices(v + d + np.asarray(shift), 'MOVING')
    return m


def _tables(mesh, origin=(-64, -64), size=640):
    """One block's table and cell candidates through the engine, source
    origin (0, 0)."""
    eng = MeshRenderer.from_mesh(mesh, device='cpu')._get_device_engine()
    sel = np.arange(len(eng._w))
    tab = eng._table_for_block(sel, origin, (0, 0), eng._w)
    cand = eng._cells_for_block(sel, origin, size, size)
    return torch.from_numpy(tab[None]), torch.from_numpy(cand[None])


def _against_cv2(img, src, src_hw, fill, kind, interp):
    """(the raster's covered output, cv2.remap's Lanczos-4 at the raster's
    own winning coordinates) of a 640^2 block over the mesh."""
    tabs, cands = _tables(_mesh())
    (out,), _, st = render.raster_blocks_plain(
        src, tabs, cands, fill, 640, 640, False, kind, src_hw=src_hw,
        return_state=True, interp=interp)
    cov = (st[0] != -np.inf)[0].numpy()
    want = cv2.remap(img, st[1][0].numpy(), st[2][0].numpy(), LANCZOS,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=fill)
    return out[0].numpy()[cov], want[cov]


def _within(got, want, kind):
    """Whether ``got`` is as close to cv2's Lanczos-4 as the tolerances
    above allow."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    if kind == 'f32':
        return bool(d.max() <= F32_ABS)
    return bool(d.max() <= INT_LSB and (d > 0).mean() <= INT_SHARE)


@pytest.mark.parametrize('fill', [0.0, 255.0])
@pytest.mark.parametrize('edge', ['whole', 'cut'])
@pytest.mark.parametrize('kind', ['u8', 'u16', 'f32'])
def test_plain_lanczos_matches_cv2_remap(kind, edge, fill):
    """The block reaches 64 px past the source on every side, so taps at
    every edge read the fill; 'cut' passes a per-block crop whose real
    extents are 300 of its 512 rows (the rest holds 77, never read)."""
    img = _source(kind)
    src, src_hw = torch.from_numpy(img), None
    if edge == 'cut':
        crop = np.full_like(img, 77)
        crop[:300] = img[:300]
        src, src_hw, img = torch.from_numpy(crop[None]), [(300, 512)], \
            np.ascontiguousarray(img[:300])
    got, want = _against_cv2(img, src, src_hw, fill, kind, 'lanczos4')
    assert _within(got, want, kind)


@pytest.mark.parametrize('kind', ['u8', 'u16', 'f32'])
def test_a_linear_render_in_lanczos_place_fails_the_tolerances(kind):
    img = _source(kind)
    got, want = _against_cv2(img, torch.from_numpy(img), None, 0.0, kind,
                             'linear')
    assert not _within(got, want, kind)


def test_lanczos_weights_are_opencvs():
    """Each fraction's weights sum to 1 and are cv2's: a 1-px-wide impulse
    sampled by cv2.remap at each 1/32 px fraction gives the table's row."""
    lw = render.lanczos4_table()
    assert lw.shape == (32, 8) and lw.dtype == np.float32
    assert np.allclose(lw.sum(axis=1), 1.0, atol=1e-6)
    assert np.array_equal(lw[0], np.eye(8, dtype=np.float32)[3])
    img = np.zeros((1, 16), np.float32)
    for i in range(8):
        img[:] = 0
        img[0, 8 - 3 + i] = 1.0
        xs = (8 + np.arange(32, dtype=np.float32) / 32)[None]
        got = cv2.remap(img, xs, np.zeros_like(xs), LANCZOS,
                        borderMode=cv2.BORDER_REPLICATE)[0]
        assert np.allclose(got, lw[:, i], atol=1e-6), i


def _reference(mesh, img, bbox, dtype=torch.float32):
    return reference.render(torch.from_numpy(img),
                            mesh.vertices_w_offset('MOVING'),
                            mesh.vertices_w_offset('INITIAL'),
                            mesh.triangles, bbox, 0.0, dtype, block=256)


@pytest.mark.parametrize('case', ['warped', 'shifted_past_the_edge',
                                  'coarse'])
def test_plain_path_matches_the_reference(case):
    """The card route of ``MeshRenderer.crop`` (the plain raster here) at
    LANCZOS against the benchmark's plain reference. The two find a pixel's
    triangle in different arithmetic (block-local f32 tables, f32 world
    positions), so a pixel on a triangle's edge may take the neighbour,
    whose map agrees there only to about the f32 rounding of world
    positions, and a pixel on the mesh's own edge may be covered by one
    alone. So the coverage may differ on 0.1% of the pixels (measured
    5e-5); where both cover a pixel, its snap to 1/32 px may fall one step
    apart, a few LSB where the texture is steepest: more than 1 LSB on at
    most 1e-4 of the pixels (measured 2e-5), under 0.01 LSB on average
    (measured 4e-4). LINEAR in LANCZOS's place reads 1.6-1.7 LSB on
    average, over 1 LSB on 43-45% of the pixels."""
    mesh = {'warped': _mesh(),
            'shifted_past_the_edge': _mesh(shift=(37.3, -21.6)),
            'coarse': _mesh(mesh_size=128, amp=6.0)}[case]
    assert 20 <= mesh.num_triangles <= 200
    img = _texture(512)
    bbox = (-32, -32, 544, 544)
    r = MeshRenderer.from_mesh(mesh, image_loader=StreamLoader(img),
                               device='cpu')
    want, cov = _reference(mesh, img, bbox)
    want, cov = want.numpy(), cov.numpy()
    mine = _coverage(mesh, bbox)
    assert (mine != cov).mean() <= 1e-3
    both = mine & cov

    def close(got):
        d = np.abs(got[both].astype(np.int32) - want[both].astype(np.int32))
        return bool((d > 1).mean() <= 1e-4 and d.mean() < 0.01)
    assert close(r.crop(bbox, interpolation=LANCZOS, device_render=True))
    assert not close(r.crop(bbox, device_render=True))


def _coverage(mesh, bbox):
    """The card route's coverage of ``bbox``: a render of a constant 255
    source with fill 0."""
    r = MeshRenderer.from_mesh(
        mesh, image_loader=StreamLoader(np.full((512, 512), 255, np.uint8)),
        device='cpu')
    return r.crop(bbox, interpolation=LANCZOS, device_render=True,
                  fillval=0) > 0


def test_card_route_matches_the_host_route():
    """``MeshRenderer.crop`` at LANCZOS, card route against host route
    (``cv2.remap`` on a crop 2 px past the block's source coordinates). The
    host route's taps beyond its crop read the fill, so the outermost px of
    the block differ by a few LSB: a 4 px border is left out. Inside it, 1
    LSB at most but on a thin band of triangle edges, as the LINEAR routes
    (``test_torch_render._compare``)."""
    mesh = _mesh()
    img = _texture(512)
    r = MeshRenderer.from_mesh(mesh, image_loader=StreamLoader(img),
                               device='cpu')
    bbox = (16, 16, 496, 480)
    dev = r.crop(bbox, interpolation=LANCZOS, device_render=True)
    host = r.crop(bbox, interpolation=LANCZOS, device_render=False)
    d = np.abs(dev.astype(np.int32) - host.astype(np.int32))[4:-4, 4:-4]
    assert (d > 1).mean() <= 2e-3 and d.mean() < 0.05, ((d > 1).mean(),
                                                         d.mean())


def test_the_renderer_takes_lanczos_to_the_engine(monkeypatch):
    """At LANCZOS the card route renders through the engine in the
    Lanczos-4 mode and never calls the host's ``render_by_subregions``;
    CUBIC stays on the host."""
    seen = []
    orig = render.raster_blocks

    def spy(*a, **k):
        seen.append(k.get('interp'))
        return orig(*a, **k)
    monkeypatch.setattr(render, 'raster_blocks', spy)
    host = []
    monkeypatch.setattr(prenderer, 'render_by_subregions',
                        lambda *a, **k: host.append(1) or np.zeros((1, 1)))
    r = MeshRenderer.from_mesh(_mesh(), image_loader=StreamLoader(
        _texture(512)), device='cpu')
    r.crop_multiple([(0, 0, 256, 256), (256, 0, 512, 256)],
                    interpolation=LANCZOS, device_render=True)
    assert seen == ['lanczos4'] and not host
    r.crop((0, 0, 64, 64), interpolation=cv2.INTER_CUBIC, device_render=True)
    assert host == [1]


@pytest.mark.parametrize('depth', [1, 2])
def test_volume_renderer_at_lanczos_takes_the_card_route(tmp_path,
                                                         monkeypatch, depth):
    """``VolumeRenderer`` at the shipped ``remap_interp: LANCZOS`` renders
    its chunks on the card route (per-z and slab-grouped): no host
    ``render_by_subregions``, every block counted Lanczos-4, and each chunk
    equal to ``MeshRenderer.crop``'s card route."""
    monkeypatch.setattr(pdal, 'ts', _tslite)
    monkeypatch.setattr(prenderer, 'render_by_subregions', None)
    img = _texture(256)
    mesh = _mesh(n=256, mesh_size=64)
    writer = pdal.TensorStoreWriter.create(
        str(tmp_path / 'vol'), (0, 0, 256, 256), depth,
        driver='neuroglancer_precomputed', chunk_shape=[128, 128, depth])
    vr = prenderer.VolumeRenderer([(0, 'sec', mesh)],
                                  {'sec': StreamLoader(img)}, writer,
                                  remap_interp='LANCZOS', device_render=True,
                                  device='cpu')
    trace.reset_counters()
    assert vr.render_volume() == 4
    c = trace.counters()
    assert c['render.blocks'] == 4 and c['render.lanczos_px'] == 4 * 128 ** 2
    r = MeshRenderer.from_mesh(mesh, image_loader=StreamLoader(img),
                               device='cpu')
    for bbox in ((0, 0, 128, 128), (128, 128, 256, 256)):
        want = r.crop(bbox, interpolation=LANCZOS, device_render=True)
        got = np.asarray(writer.read_chunk(bbox, 0))
        assert np.array_equal(got.reshape(want.shape), want)


# sha256 (first 16 hex digits) of LINEAR renders made before the Lanczos
# mode existed (the parent tree, on the CPU), by ``_linear_renders``
LINEAR_DIGESTS = {'u8-flat': '9f953a4a9ecaf043', 'u8-cells': '9f953a4a9ecaf043',
                  'u16-flat': '5440f751d6cf9645',
                  'u16-cells': '5440f751d6cf9645',
                  'f32-flat': 'b0a9ef84a37bf717',
                  'f32-cells': 'b0a9ef84a37bf717', 'u8-crop': '0261ad310bb9e9a8',
                  'crop': '426d2a6f1d27fb44'}


def _linear_renders():
    """LINEAR renders: the plain raster on engine tables (cells and flat,
    u8 / u16 / f32 out, a per-block crop with its extents) and
    ``MeshRenderer.crop`` on the card route."""
    img = _texture(512)
    mesh = _mesh()
    t, c = _tables(mesh)
    src = torch.from_numpy(img)
    out = {}
    for kind in ('u8', 'u16', 'f32'):
        for cells in (False, True):
            (o,), _ = render.raster_blocks_plain(
                src, t, c if cells else None, 7.0, 640, 640, False, kind)
            out[f'{kind}-{"cells" if cells else "flat"}'] = o.numpy()
    crop = np.full((512, 512), 77, np.uint8)
    crop[:300] = img[:300]
    (o,), _ = render.raster_blocks_plain(
        torch.from_numpy(crop[None]), t, c, 0.0, 640, 640, False, 'u8',
        src_hw=[(300, 512)])
    out['u8-crop'] = o.numpy()
    r = MeshRenderer.from_mesh(mesh, image_loader=StreamLoader(img),
                               device='cpu')
    out['crop'] = r.crop((-20, -20, 530, 530), device_render=True)
    return out


def test_linear_output_is_byte_equal_to_the_parents():
    got = {k: hashlib.sha256(v.tobytes()).hexdigest()[:16]
           for k, v in _linear_renders().items()}
    assert got == LINEAR_DIGESTS


def test_the_renderer_opens_its_spans_and_moves_its_counters(monkeypatch):
    """Card route: ``render.raster`` and ``render.tables`` spans, every
    block counted (none on a card here), each Lanczos-4 block's px; host
    route: ``render.raster``, its 4096^2 blocks and px; LINEAR counts no
    Lanczos-4 px."""
    img = _texture(512)
    r = MeshRenderer.from_mesh(_mesh(), image_loader=StreamLoader(img),
                               device='cpu')
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.crop_multiple([(0, 0, 256, 256), (0, 0, 512, 300)],
                        interpolation=LANCZOS, device_render=True,
                        block_size=256)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {trace.PREFIX + 'render.raster',
            trace.PREFIX + 'render.tables'} <= names
    c = trace.counters()
    assert c['render.blocks'] == 1 + 4 and 'render.device_blocks' not in c
    assert c['render.lanczos_px'] == 256 * 256 + 512 * 300
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.crop((0, 0, 300, 200), interpolation=LANCZOS, device_render=False)
        r.crop((0, 0, 300, 200), device_render=False)
    assert trace.PREFIX + 'render.raster' in {
        e.name() for e in prof.profiler.kineto_results.events()}
    c = trace.counters()
    assert c['render.blocks'] == 2 and c['render.lanczos_px'] == 300 * 200
    trace.reset_counters()
    r.crop((0, 0, 300, 200), device_render=True)
    c = trace.counters()
    assert c['render.blocks'] == 1 and 'render.lanczos_px' not in c


@pytest.mark.cuda
@pytest.mark.parametrize('interp', [cv2.INTER_LINEAR, LANCZOS])
def test_card_crop_is_bit_equal_to_the_plain_crop(interp):
    """On the card: ``MeshRenderer.crop`` renders its blocks with the
    kernel (every block counted on the card, Lanczos-4 launches under their
    own counter) and gives the bytes of the plain route on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    from feabas_tpu_torch import device as device_mod
    img = _texture(512)
    mesh = _mesh(shift=(11.4, -7.7))
    bbox = (-40, -40, 560, 560)
    want = MeshRenderer.from_mesh(mesh, image_loader=StreamLoader(img),
                                  device='cpu').crop(
        bbox, interpolation=interp, device_render=True, block_size=256)
    trace.reset_counters()
    got = MeshRenderer.from_mesh(mesh, image_loader=StreamLoader(img),
                                 device='cuda').crop(
        bbox, interpolation=interp, device_render=True, block_size=256)
    assert np.array_equal(got, want)
    c = trace.counters()
    assert c['render.blocks'] == c['render.device_blocks'] > 0
    launches = device_mod.launch_counts()
    lz = interp == LANCZOS
    assert (launches['mesh_raster_lanczos4'] > 0) == lz
    assert (launches['mesh_raster'] > 0) != lz
