"""The port's mesh raster (ops/render.py) and MeshRenderer against the JAX
package: the plain raster against ``_raster_core`` / ``_raster_core_cells``
(bit-equal state, u8 within 1 LSB), device crops against the host cv2
crop, the hybrid lane, and the render-lane resolution. The port receives
its own meshes (rebuilt from the JAX meshes' init dicts through ``state``)
and its own loaders."""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the JAX package's storage imports h5py at load; on a host without it
# (the GPU machine) the port's standard-HDF5 subset stands in for it in
# this test process (the port itself needs no such patch)
try:
    import h5py  # noqa: F401
except ImportError:
    from feabas_tpu_torch import _h5lite
    sys.modules['h5py'] = _h5lite

from feabas_tpu.dal import StreamLoader as JStreamLoader
from feabas_tpu.mesh import Mesh
from feabas_tpu.ops import render as R
from feabas_tpu.renderer import MeshRenderer as HostRenderer
from feabas_tpu_torch import config as pconfig
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch import state
from feabas_tpu_torch.dal import StaticImageLoader, StreamLoader
from feabas_tpu_torch.ops import link_probe, render
from feabas_tpu_torch.renderer import MeshRenderer, resolve_device_render

# the tier-1 run shares the cores among several pytest workers
torch.set_num_threads(1)

CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU, asked for by name; the port's config caches start and end
    empty (``workdir`` clears only the JAX package's)."""
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


def _p(mesh):
    """The port's copy of a JAX mesh."""
    return state.mesh_from_init_dict(mesh.get_init_dict())


def _smooth_mesh(N=512, mesh_size=64, amp=4.0):
    m = Mesh.from_bbox((0, 0, N, N), cartesian=True, mesh_size=mesh_size,
                       resolution=4)
    v = m.vertices(1)
    m.set_vertices(v + np.stack([amp * np.sin(v[:, 1] / 97),
                                 amp * np.cos(v[:, 0] / 83)], -1), 1,
                   offset=m.offset(1))
    return m


def _folded_mesh():
    m = Mesh.from_bbox((0, 0, 120, 60), cartesian=True, mesh_size=20)
    v = m.vertices('FIXED').copy()
    sel = v[:, 0] > 80
    v[sel, 0] = 160 - v[sel, 0]
    m.set_vertices(v, 'MOVING')
    return m


def _world(N=512, seed=3):
    from scipy.ndimage import gaussian_filter
    w = gaussian_filter(np.random.default_rng(seed).normal(0, 1, (N, N)), 1.5)
    return (w / w.std() * 40 + 128).clip(0, 255).astype(np.uint8)


def _compare(host, dev, max_mismatch_frac=2e-3, lsb=1):
    """test_device_render._compare: all but a thin rasterization-edge band
    within ``lsb``."""
    assert host.shape == dev.shape and host.dtype == dev.dtype
    bad = np.abs(host.astype(np.int32) - dev.astype(np.int32)) > lsb
    assert bad.mean() <= max_mismatch_frac, bad.mean()


def _jax_state(monkeypatch):
    """Capture the raster state the JAX program hands _finish_raster."""
    cap = {}
    orig = R._finish_raster

    def grab(src, score, sx, sy, smask, *a):
        cap['state'] = [np.asarray(v) for v in (score, sx, sy, smask)]
        return orig(src, score, sx, sy, smask, *a)
    monkeypatch.setattr(R, '_finish_raster', grab)
    return cap


def _engine_block(mesh, loader, bbox, **kw):
    """JAX engine: (resident source, table, cells) of one block."""
    r = HostRenderer.from_mesh(mesh, image_loader=loader, **kw)
    eng = r._get_device_engine()
    res = eng._resident_source(loader, 0)
    x0, y0, x1, y1 = bbox
    tb = eng._tb
    sel = np.nonzero((tb[:, 0] < x1) & (tb[:, 2] > x0) & (tb[:, 1] < y1)
                     & (tb[:, 3] > y0) & np.isfinite(eng._w))[0]
    tab = eng._table_for_block(sel, (x0, y0), res[1], eng._w)
    cand = eng._cells_for_block(sel, (x0, y0), y1 - y0, x1 - x0)
    return eng, res, tab, cand


@pytest.mark.parametrize('case', ['smooth', 'fold_geodesic'])
@pytest.mark.parametrize('cells', [False, True])
def test_plain_raster_matches_jax_state(case, cells, monkeypatch):
    """Score, winning source coordinate, fold-sheet mask and coverage are
    bit-equal to the JAX flat program's (``_raster_core``), for the
    port's flat and cell-binned forms; the u8 output is within 1 LSB (it
    is equal). The JAX cells program is an exact rewrite of the flat one
    on the smooth mesh and is held to the same; on this fold its own
    fold-sheet mask and coverage differ from the flat program's at a few
    triangle-edge pixels (XLA contracts its l1/l2 arithmetic differently),
    so there the flat program is the reference."""
    cap = _jax_state(monkeypatch)
    if case == 'smooth':
        mesh, img, bbox, kw = (_smooth_mesh(mesh_size=48), _world(),
                               (0, 0, 512, 512), {})
    else:
        mesh, img, bbox, kw = (_folded_mesh(), _world(N=128)[:60, :120],
                               (0, 0, 128, 128),
                               {'mode': 'LEAST_DEFORM', 'geodesic_mask': True})
    eng, res, tab, cand = _engine_block(mesh, JStreamLoader(img), bbox, **kw)
    assert eng._geodesic == (case != 'smooth')
    h = w = bbox[2]
    refs = [np.asarray(R._raster_core(res[0], jnp.asarray(tab), jnp.float32(7),
                                      h, w, eng._geodesic, 'u8'))]
    states = [cap['state']]
    if cells and not eng._geodesic:
        refs.append(np.asarray(R._raster_core_cells(
            res[0], jnp.asarray(tab), jnp.asarray(cand), jnp.float32(7), h, w,
            eng._geodesic, 'u8')))
        states.append(cap['state'])
    # the port's engine builds the same table; its resident source is the
    # JAX buffer before the u8 quad packing
    loader = StreamLoader(img)
    pe = MeshRenderer.from_mesh(_p(mesh), image_loader=loader, device='cpu',
                                **kw)._get_device_engine()
    psrc, porigin = pe._resident_source(loader, 0)
    sel = np.nonzero(np.isfinite(pe._w) & (pe._tb[:, 0] < w) & (pe._tb[:, 2] > 0)
                     & (pe._tb[:, 1] < h) & (pe._tb[:, 3] > 0))[0]
    assert np.array_equal(pe._table_for_block(sel, (0, 0), porigin, pe._w), tab)
    src, tabs, cands = state.render_batch_to_device(
        psrc.numpy(), tab[None], cand[None] if cells else None, CPU)
    levels, cov, st = render.raster_blocks_plain(
        src, tabs, cands, 7.0, h, w, eng._geodesic, 'u8', return_state=True)
    score, sx, sy, smask, win = (a[0].numpy() for a in st)
    for want, (j_score, j_sx, j_sy, j_mask) in zip(refs, states):
        assert np.array_equal(score, j_score)
        assert np.array_equal(sx, j_sx) and np.array_equal(sy, j_sy)
        assert np.array_equal(smask, j_mask)
        diff = np.abs(levels[0][0].numpy().astype(int)
                      - want[:-1].reshape(h, w).astype(int))
        assert diff.max() <= 1
        assert bool(cov[0]) == bool(want[-1])
    # a winning row wherever some row covered the pixel
    assert ((win >= 0) == np.isfinite(score)).all()


@pytest.mark.parametrize('out_kind', ['u16', 'f32'])
def test_plain_raster_out_kinds_and_mips(out_kind):
    """u16 and f32 outputs, f32 sources and the fused mip chain against
    the JAX program (mip levels within 1 LSB)."""
    mesh = _smooth_mesh(mesh_size=48)
    img = (_world().astype(np.float32) * (3.0 if out_kind == 'u16' else 0.5))
    eng, res, tab, _ = _engine_block(mesh, JStreamLoader(img), (0, 0, 512, 512))
    want = np.asarray(R._raster_core(res[0], jnp.asarray(tab), jnp.float32(0),
                                     512, 512, False, out_kind, n_mips=2,
                                     mip_blur=0.75)).astype(np.float64)
    src, tabs, _ = state.render_batch_to_device(np.asarray(res[0]), tab[None],
                                                None, CPU)
    levels, cov = render.raster_blocks_plain(src, tabs, None, 0.0, 512, 512,
                                             False, out_kind, n_mips=2,
                                             mip_blur=0.75)
    off = 0
    for lvl, got in enumerate(levels):
        n = (512 >> lvl) ** 2
        d = np.abs(got[0].numpy().astype(np.float64).ravel()
                   - want[off:off + n])
        assert d.max() <= (1.0 if out_kind == 'u16' else 1e-3), (lvl, d.max())
        off += n
    assert off == render._flat_len(512, 512, 2) - 1 and bool(cov[0])


def test_per_block_sources_use_their_own_extents():
    """A batch of blocks each with its own source crop, padded into one
    stack: every block samples only inside its real extents."""
    rng = np.random.default_rng(0)
    tab = np.zeros((8, 14), np.float32)
    tab[:, 2], tab[:, 12], tab[:, 13] = -2.0, -np.inf, -1.0
    tab[0, :6] = [0, 0, 0.25, 0, 0, 0.25]
    tab[0, 6], tab[0, 10], tab[0, 12] = 1.0, 1.0, 1.0    # identity affine
    crops = [rng.integers(1, 255, (h, w)).astype(np.uint8)
             for h, w in ((40, 50), (64, 30))]
    stack = np.zeros((2, 64, 64), np.uint8)
    for k, c in enumerate(crops):
        stack[k, :c.shape[0], :c.shape[1]] = c
    src, tabs, _ = state.render_batch_to_device(stack, np.stack([tab, tab]),
                                                None, CPU)
    levels, cov = render.raster_blocks_plain(src, tabs, None, 0.0, 64, 64,
                                             False, 'u8',
                                             src_hw=[c.shape for c in crops])
    for k, c in enumerate(crops):
        out = levels[0][k].numpy()
        assert np.array_equal(out[:c.shape[0], :c.shape[1]], c)
        assert (out[c.shape[0]:] == 0).all() and (out[:, c.shape[1]:] == 0).all()


def test_ties_go_to_the_first_row():
    tab = np.zeros((8, 14), np.float32)
    tab[:, 2], tab[:, 12], tab[:, 13] = -2.0, -np.inf, -1.0
    for r, shift in ((0, 3.0), (1, 9.0)):
        tab[r, :6] = [0, 0, 0.25, 0, 0, 0.25]
        tab[r, 6], tab[r, 8], tab[r, 10], tab[r, 12] = 1.0, shift, 1.0, 1.0
    img = _world(N=128)
    src, tabs, _ = state.render_batch_to_device(img, tab[None], None, CPU)
    levels, _, st = render.raster_blocks_plain(src, tabs, None, 0.0, 64, 64,
                                               False, 'u8', return_state=True)
    assert (st[4] == 0).all()
    assert np.array_equal(levels[0][0].numpy(), img[:64, 3:67])


def test_device_crops_match_host(workdir, tmp_path):
    """The port's MeshRenderer device crop (the plain raster on the CPU):
    a resident whole-section source with an uncovered margin, and an
    on-disk source cropped per block, against the host cv2 crop."""
    from feabas_tpu_torch import common
    m = _p(_smooth_mesh())
    r = MeshRenderer.from_mesh(m, image_loader=StreamLoader(_world()),
                               device='cpu')
    host = r.crop((-16, -16, 300, 280), device_render=False)
    dev = r.crop((-16, -16, 300, 280), device_render=True)
    _compare(host, dev)
    assert (dev[:8, :8] == host[:8, :8]).all()
    fn = str(tmp_path / 'tile.png')
    common.imwrite(fn, _world(N=400))
    loader = StaticImageLoader([fn], bboxes=[(0, 0, 400, 400)])
    r = MeshRenderer.from_mesh(_p(_smooth_mesh(N=400)), image_loader=loader,
                               device='cpu')
    _compare(r.crop((0, 0, 400, 400), device_render=False, fileid=0),
             r.crop((0, 0, 400, 400), device_render=True, fileid=0))
    # folded mesh with geodesic masking
    img = _world(N=128)[:60, :]
    r = MeshRenderer.from_mesh(_p(_folded_mesh()),
                               image_loader=StreamLoader(img[:, :120]),
                               mode='LEAST_DEFORM', geodesic_mask=True,
                               device='cpu')
    _compare(r.crop((0, 0, 120, 60), device_render=False),
             r.crop((0, 0, 120, 60), device_render=True),
             max_mismatch_frac=0.02)


def test_render_blocks_matches_jax_engine(workdir):
    """The port's engine against the JAX engine, over flat and cells
    blocks, batches of 1 and 4, and the fused mips."""
    m = _smooth_mesh(N=768, mesh_size=40)
    img = _world(N=1024)
    jloader, loader = JStreamLoader(img), StreamLoader(img)
    blocks = [(0, 0, 512, 512), (512, 0, 1024, 512), (0, 512, 512, 1024),
              (512, 512, 1024, 1024), (700, 700, 830, 760)]
    jr = HostRenderer.from_mesh(m, image_loader=jloader)._get_device_engine()
    pr = MeshRenderer.from_mesh(_p(m), image_loader=loader,
                                device='cpu')._get_device_engine()
    for cap in (1, 4):
        want = jr.render_blocks(blocks, jloader, 0, np.uint8, group_cap=cap,
                                emit_mips=1)
        got = pr.render_blocks(blocks, loader, 0, np.uint8, group_cap=cap,
                               emit_mips=1)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                for a, b in zip(g, w):
                    assert a.shape == b.shape
                    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_hybrid_render_matches_host(workdir):
    m = _p(_smooth_mesh(N=1024, mesh_size=128))
    r = MeshRenderer.from_mesh(m, image_loader=StreamLoader(_world(N=1024)),
                               device='cpu')
    tiles = [(x, y, x + 256, y + 256)
             for y in range(0, 1024, 256) for x in range(0, 1024, 256)]
    host = r.crop_multiple(tiles, return_empty=True, device_render=False)
    hyb = r.crop_multiple(tiles, return_empty=True, device_render='hybrid')
    assert len(hyb) == len(host)
    for hb, yb in zip(host, hyb):
        assert (hb is None) == (yb is None)
        if hb is not None:
            _compare(hb, yb)


def test_resolve_device_render_follows_the_jax_package(workdir):
    """'auto' is the host path on the CPU and 'hybrid' on a CUDA device,
    as feabas_tpu.renderer.resolve_device_render decides per backend;
    'hybrid', 'true' and 'false' map as there."""
    cuda = torch.device('cuda')
    assert resolve_device_render('auto', CPU) is False
    assert resolve_device_render('auto', cuda) == 'hybrid'
    for dev in (CPU, cuda):
        assert resolve_device_render('hybrid', dev) == 'hybrid'
        assert resolve_device_render('true', dev) is True
        assert resolve_device_render('false', dev) is False
        assert resolve_device_render(True, dev) is True
        assert resolve_device_render(False, dev) is False
    # None reads general_configs device.render ('auto' by default)
    assert resolve_device_render(None, cuda) == 'hybrid'


def test_resolve_group_cap_follows_the_link_profile():
    try:
        link_probe.set_profile_for_testing(
            {'platform': 'cuda', 'latency_s': 0.12,
             'down_MBps': 40.0, 'up_MBps': 54.0})
        assert render.resolve_group_cap('auto') == 1
        assert render.resolve_group_cap('auto', block_pixels=128 * 128) == 16
        assert render.resolve_group_cap('auto', block_pixels=2048 * 2048) == 1
        link_probe.set_profile_for_testing(None)
        assert link_probe.link_profile(device='cpu')['latency_s'] == 0.0
        assert render.resolve_group_cap('auto') == 4
        assert render.resolve_group_cap('auto', block_pixels=512 * 512) == 4
        assert render.resolve_group_cap(2, block_pixels=128 * 128) == 2
    finally:
        link_probe.set_profile_for_testing(None)


@pytest.mark.cuda
def test_raster_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    dev = device_mod.get_device('cuda')
    mesh = _p(_smooth_mesh(N=1024, mesh_size=40))
    loader = StreamLoader(_world(N=1024))
    eng = MeshRenderer.from_mesh(mesh, device=dev)._get_device_engine()
    resident, origin = eng._resident_source(loader, 0)
    tb = eng._tb
    sel = np.nonzero((tb[:, 0] < 512) & (tb[:, 2] > 0) & (tb[:, 1] < 512)
                     & (tb[:, 3] > 0))[0]
    tab = eng._table_for_block(sel, (0, 0), origin, eng._w)
    cand = eng._cells_for_block(sel, (0, 0), 512, 512)
    for cands in (None, cand[None]):
        _, tabs, cd = state.render_batch_to_device(None, tab[None], cands, dev)
        got, cov = render.raster_blocks(resident, tabs, cd, 0.0, 512, 512,
                                        False, 'u8')
        want, pcov = render.raster_blocks_plain(resident, tabs, cd, 0.0, 512,
                                                512, False, 'u8')
        assert torch.equal(got[0], want[0]) and torch.equal(cov, pcov)
