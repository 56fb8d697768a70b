"""The port's mesh raster (ops/render.py) and MeshRenderer against the JAX
package: the plain raster against ``_raster_core`` / ``_raster_core_cells``
(bit-equal state, u8 within 1 LSB), device crops against the host cv2
crop, 'hybrid' read as the device engine, and the route's resolution by
the compute device. The port receives
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
from feabas_tpu_torch.ops import render
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


def _near_lanczos(want, got):
    """``test_torch_render_lanczos.test_card_route_matches_the_host_route``'s
    tolerance: the host route crops its source 2 px past a block's source
    coordinates and reads the fill beyond, so a 4 px border is left out;
    inside it, over 1 LSB only on a thin band of triangle edges."""
    assert want.shape == got.shape and want.dtype == got.dtype
    d = np.abs(want.astype(np.int32) - got.astype(np.int32))[4:-4, 4:-4]
    return bool((d > 1).mean() <= 2e-3 and d.mean() < 0.05)


@pytest.mark.parametrize('call', ['crop', 'crop_multiple'])
def test_lanczos_card_route_matches_the_jax_package(call, workdir,
                                                    monkeypatch):
    """The port's card route at LANCZOS (the plain raster on the CPU)
    against the JAX package's render of the same mesh and image at LANCZOS
    (``crop_field`` in f64, then ``cv2.remap``): one bbox through ``crop``,
    two overlapping ones through ``crop_multiple``. The port's host route is
    barred, so a pass is the card route's (measured: over 1 LSB on 1e-5 of
    the px, 0.0024 LSB on average). LINEAR in LANCZOS's place fails the
    same tolerance (over 1 LSB on 43% of the px, 1.56 LSB on average)."""
    import cv2
    from feabas_tpu_torch import renderer as prenderer

    def no_host(*a, **k):
        raise AssertionError('the host route rendered a block')
    monkeypatch.setattr(prenderer, 'render_by_subregions', no_host)
    m = _smooth_mesh()
    img = _world()
    jr = HostRenderer.from_mesh(m, image_loader=JStreamLoader(img))
    pr = MeshRenderer.from_mesh(_p(m), image_loader=StreamLoader(img),
                                device='cpu')
    bboxes = ([(16, 16, 496, 480)] if call == 'crop' else
              [(16, 16, 272, 300), (200, 160, 496, 480)])

    def render(r, interp, **kw):
        if call == 'crop':
            return [r.crop(bboxes[0], interpolation=interp, **kw)]
        return r.crop_multiple(bboxes, interpolation=interp, **kw)
    want = render(jr, cv2.INTER_LANCZOS4)
    got = render(pr, cv2.INTER_LANCZOS4, device_render=True)
    assert all(_near_lanczos(w, g) for w, g in zip(want, got))
    linear = render(pr, cv2.INTER_LINEAR, device_render=True)
    assert not any(_near_lanczos(w, g) for w, g in zip(want, linear))


@pytest.mark.parametrize('cap', [1, 4])
def test_render_blocks_matches_jax_engine(cap, workdir, monkeypatch):
    """The port's engine against the JAX engine, over flat and cells
    blocks, batches of ``cap`` blocks, and the fused mips."""
    m = _smooth_mesh(N=768, mesh_size=40)
    img = _world(N=1024)
    jloader, loader = JStreamLoader(img), StreamLoader(img)
    blocks = [(0, 0, 512, 512), (512, 0, 1024, 512), (0, 512, 512, 1024),
              (512, 512, 1024, 1024), (700, 700, 830, 760)]
    jr = HostRenderer.from_mesh(m, image_loader=jloader)._get_device_engine()
    pr = MeshRenderer.from_mesh(_p(m), image_loader=loader,
                                device='cpu')._get_device_engine()
    monkeypatch.setattr(render, '_group_cap', lambda block_pixels: cap)
    want = jr.render_blocks(blocks, jloader, 0, np.uint8, group_cap=cap,
                            emit_mips=1)
    got = pr.render_blocks(blocks, loader, 0, np.uint8, emit_mips=1)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            for a, b in zip(g, w):
                assert a.shape == b.shape
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_hybrid_reads_as_the_card_and_starts_no_host_lane(workdir,
                                                          monkeypatch):
    """'hybrid' renders 16 tiles on the device engine alone: no block
    takes the host path, and the output is the device_render=True output,
    bit for bit."""
    m = _p(_smooth_mesh(N=1024, mesh_size=128))
    r = MeshRenderer.from_mesh(m, image_loader=StreamLoader(_world(N=1024)),
                               device='cpu')
    tiles = [(x, y, x + 256, y + 256)
             for y in range(0, 1024, 256) for x in range(0, 1024, 256)]
    host_calls = []

    def no_host_path(*a, **k):
        host_calls.append(a)
        raise AssertionError('the host path rendered a block')
    monkeypatch.setattr(MeshRenderer, 'crop_field', no_host_path)
    dev = r.crop_multiple(tiles, return_empty=True, device_render=True)
    hyb = r.crop_multiple(tiles, return_empty=True, device_render='hybrid')
    assert host_calls == []
    assert len(hyb) == len(dev) == 16
    for db, hb in zip(dev, hyb):
        assert db is not None and hb is not None
        assert db.dtype == hb.dtype and np.array_equal(db, hb)


@pytest.mark.parametrize('flag, on_cpu, on_cuda', [
    (None, False, True), ('auto', False, True), ('hybrid', True, True),
    ('true', True, True), ('false', False, False), (True, True, True),
    (False, False, False)])
def test_resolve_device_render_follows_the_compute_device(flag, on_cpu,
                                                          on_cuda, workdir):
    """'auto' (and None, which reads general_configs device.render,
    'auto' by default) is the device engine on a CUDA device and the host
    path elsewhere; 'hybrid' is the device engine on any device; every
    answer is a bool."""
    for dev, want in ((CPU, on_cpu), (torch.device('cuda'), on_cuda)):
        got = resolve_device_render(flag, dev)
        assert type(got) is bool and got is want


def test_resolve_group_cap_follows_the_block_size():
    """At least 4 blocks a batch; small blocks batch up to ~1 Mpx, at
    most 16."""
    assert render._group_cap(128 * 128) == 16
    assert render._group_cap(256 * 256) == 16
    assert render._group_cap(512 * 512) == 4
    assert render._group_cap(2048 * 2048) == 4


# ------------------------------ the tile cull ------------------------------ #

def _inert(n):
    tab = np.zeros((n, 14), np.float32)
    tab[:, 2], tab[:, 12], tab[:, 13] = -2.0, -np.inf, -1.0
    return tab


def _table_from_triangles(P, rng, sheets=False):
    """(Tp, 14) table of triangles P (n, 3, 2) in block pixels, built as the
    engine builds it: near-identity affines, weights from a few values (so
    ties occur), fold-sheet colours when asked; at least one inert row
    follows."""
    n = len(P)
    a, e1, e2 = P[:, 0], P[:, 1] - P[:, 0], P[:, 2] - P[:, 0]
    den = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    ok = np.abs(den) > 1e-9
    P, a, e1, e2, den = P[ok], a[ok], e1[ok], e2[ok], den[ok]
    n = len(P)
    tab = _inert(render._align_up(n + 1, 8, 8))
    l1 = np.stack([e2[:, 1] / den, -e2[:, 0] / den], -1)
    l2 = np.stack([-e1[:, 1] / den, e1[:, 0] / den], -1)
    tab[:n, 0:2], tab[:n, 2] = l1, -(a * l1).sum(-1)
    tab[:n, 3:5], tab[:n, 5] = l2, -(a * l2).sum(-1)
    A = np.eye(2) + rng.normal(0, 0.02, (n, 2, 2))
    tab[:n, 6], tab[:n, 7] = A[:, 0, 0], A[:, 1, 0]
    tab[:n, 9], tab[:n, 10] = A[:, 0, 1], A[:, 1, 1]
    tab[:n, 8], tab[:n, 11] = rng.uniform(2, 6, (2, n))
    tab[:n, 12] = rng.choice([0.5, 1.0, 2.0], n)
    tab[:n, 13] = rng.integers(-1, 3, n) if sheets else -1.0
    return tab, P


def _cells_from_triangles(P, h, w):
    """(NC, Kp) candidates per 128-px cell by bounding box, ascending,
    padded with the inert row ``len(P)``."""
    C = render._CELL
    lo, hi = P.min(axis=1), P.max(axis=1)
    cells = []
    for cy in range(h // C):
        for cx in range(w // C):
            cells.append(np.nonzero(
                (lo[:, 0] <= (cx + 1) * C) & (hi[:, 0] >= cx * C - 1)
                & (lo[:, 1] <= (cy + 1) * C) & (hi[:, 1] >= cy * C - 1))[0])
    K = max(max(len(c) for c in cells), 1)
    Kp = max(4, 1 << (K - 1).bit_length())
    cand = np.full((len(cells), Kp), len(P), np.int32)
    for k, c in enumerate(cells):
        cand[k, :len(c)] = c
    return cand


def _random_triangles(rng, n, h, w, tile_h):
    """Random triangles of mixed orientation over (and beyond) the block,
    plus triangles whose vertices sit on tile-corner pixels, so that
    edges pass exactly through the corners the cull evaluates."""
    P = rng.uniform(-40, 1, (n, 3, 2)) + rng.uniform(
        0, 1, (n, 1, 2)) * [w + 40, h + 40] + rng.uniform(0, 90, (n, 3, 2))
    xs = np.array([0, 127, 128, w - 1], np.float64)
    ys = np.concatenate([np.arange(0, h, tile_h),
                         np.arange(tile_h - 1, h, tile_h)]).astype(np.float64)
    m = max(n // 3, 4)
    lattice = np.stack([rng.choice(xs, (m, 3)), rng.choice(ys, (m, 3))], -1)
    return np.concatenate([P, lattice])


def _check_cull(tables, cands, h, w, tile_h, geodesic):
    """The cull keeps every row that is inside at some pixel of a tile, and
    the raster state of each tile from its surviving rows alone is
    bit-equal to the state from all rows."""
    keep = render.tile_cull_plain(tables, cands, h, w, tile_h)
    B, Tp = tables.shape[:2]
    nty, ntx, n = keep.shape[1:]
    assert (nty, ntx) == (-(-h // tile_h), -(-w // 128))
    assert n == (Tp if cands is None else cands.shape[-1])
    full = render._raster_state_plain(tables, cands, h, w, geodesic)
    inert = torch.from_numpy(_inert(1)[0])
    assert torch.equal(tables[:, Tp - 1], inert.expand(B, 14))
    f32 = torch.float32
    tabs, cds, where = [], [], []
    culled = 0
    for b in range(B):
        for ty in range(nty):
            for tx in range(ntx):
                y0, x0 = ty * tile_h, tx * 128
                y1, x1 = min(y0 + tile_h, h), min(x0 + 128, w)
                k = keep[b, ty, tx]
                if cands is None:
                    rows = tables[b]
                else:
                    cell = (y0 // 128) * (w // 128) + tx
                    rows = tables[b][cands[b, cell].long()]
                gx = torch.arange(x0, x1, dtype=f32)[None, None, :]
                gy = torch.arange(y0, y1, dtype=f32)[None, :, None]

                def col(j):
                    return rows[:, j][:, None, None]
                l1 = render._affine(col(0), gx, col(1), gy, col(2))
                l2 = render._affine(col(3), gx, col(4), gy, col(5))
                inside = ((l1 >= -render._EPS) & (l2 >= -render._EPS)
                          & (l1 + l2 <= 1.0 + render._EPS)).flatten(1).any(1)
                assert not bool((inside & ~k).any()), (b, ty, tx)
                culled += int((~k).sum())
                if cands is None:
                    t = tables[b].clone()
                    t[~k] = inert
                    tabs.append(t)
                else:
                    c = cands[b].clone()
                    c[cell][~k] = Tp - 1
                    tabs.append(tables[b])
                    cds.append(c)
                where.append((b, slice(y0, y1), slice(x0, x1)))
    part = render._raster_state_plain(
        torch.stack(tabs), torch.stack(cds) if cds else None, h, w, geodesic)
    for i, (b, ys, xs) in enumerate(where):
        for got, want in zip(part, full):
            assert torch.equal(got[i, ys, xs], want[b, ys, xs]), (b, ys, xs)
    return culled, keep


@pytest.mark.parametrize('tile_h', [8, 16, 32])
@pytest.mark.parametrize('cells', [False, True])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_tile_cull_is_conservative_on_random_tables(seed, cells, tile_h):
    rng = np.random.default_rng(seed)
    h, w = (128, 256) if cells else (90, 200)
    tabs, cds = [], []
    for _ in range(2):
        tab, P = _table_from_triangles(
            _random_triangles(rng, 14, h, w, tile_h), rng, sheets=seed == 2)
        tabs.append(tab)
        if cells:
            cds.append(_cells_from_triangles(P, h, w))
    Tp = max(t.shape[0] for t in tabs)
    tt = np.stack([np.concatenate([t, _inert(Tp - t.shape[0])]) for t in tabs])
    cd = None
    if cells:
        Kp = max(c.shape[1] for c in cds)
        cd = np.full((2, cds[0].shape[0], Kp), Tp - 1, np.int32)
        for k, c in enumerate(cds):
            cd[k, :, :c.shape[1]] = c
        cd = torch.from_numpy(cd)
    culled, keep = _check_cull(torch.from_numpy(tt), cd, h, w, tile_h,
                               seed == 2)
    # the rule does remove rows, the padding among them
    assert culled > 0 and not bool(keep[..., -1].any())


@pytest.mark.parametrize('case', ['smooth_flat', 'smooth_cells', 'fold_flat',
                                  'fold_cells'])
def test_tile_cull_is_conservative_on_meshes(case):
    """The deformed and the folded mesh of this file, through the port's
    engine tables."""
    if case.startswith('smooth'):
        mesh, img, (h, w), kw = (_smooth_mesh(mesh_size=48), _world(),
                                 (256, 256), {})
    else:
        mesh, img, (h, w), kw = (_folded_mesh(), _world(N=128)[:60, :120],
                                 (128, 128),
                                 {'mode': 'LEAST_DEFORM', 'geodesic_mask': True})
    loader = StreamLoader(img)
    pe = MeshRenderer.from_mesh(_p(mesh), image_loader=loader, device='cpu',
                                **kw)._get_device_engine()
    _, origin = pe._resident_source(loader, 0)
    sel = np.nonzero(np.isfinite(pe._w) & (pe._tb[:, 0] < w) & (pe._tb[:, 2] > 0)
                     & (pe._tb[:, 1] < h) & (pe._tb[:, 3] > 0))[0]
    tab = pe._table_for_block(sel, (0, 0), origin, pe._w)
    cand = pe._cells_for_block(sel, (0, 0), h, w)
    _, tabs, cds = state.render_batch_to_device(
        None, tab[None], cand[None] if case.endswith('cells') else None, CPU)
    culled, _ = _check_cull(tabs, cds, h, w, 32, pe._geodesic)
    assert culled > 0


# --------------------- no CPU default outside get_device -------------------- #

def _engine(device):
    m = _p(_smooth_mesh(N=128, mesh_size=64))
    return render.DeviceRenderEngine(m, 'FIXED', 'MOVING',
                                     np.ones(len(m.triangles)), device=device)


@pytest.mark.parametrize('entry', ['engine', 'xcorr_fft'])
def test_device_none_means_the_card(entry, monkeypatch):
    """``device=None`` resolves through ``get_device``: the CUDA card, and
    an error where there is none; the CPU only when asked for by name or
    through FEABAS_TORCH_DEVICE."""
    from feabas_tpu_torch.ops import xcorr
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, (2, 32, 32)).astype(np.float32)
    b = np.roll(a, 3, axis=2)

    def call(device):
        if entry == 'engine':
            return _engine(device).device
        dx, dy, _ = xcorr.xcorr_fft(a, b, device=device)
        assert np.abs(dx - 3).max() < 0.5 and np.abs(dy).max() < 0.5
        return CPU

    assert call('cpu') == CPU                         # asked for by name
    assert call(None) == CPU                          # asked for by the env
    monkeypatch.delenv('FEABAS_TORCH_DEVICE')
    if torch.cuda.is_available():
        if entry == 'engine':
            assert call(None).type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        call(None)
    assert call('cpu') == CPU


def _card_case(case, dev):
    """(src, tables, cands, h, w, geodesic, out_kind) of one kernel edge
    case, on ``dev``."""
    rng = np.random.default_rng(11)

    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(dev)

    if case.startswith('fold'):
        img = _world(N=128)[:60, :120]
        loader = StreamLoader(img)
        eng = MeshRenderer.from_mesh(
            _p(_folded_mesh()), image_loader=loader, mode='LEAST_DEFORM',
            geodesic_mask=True, device=dev)._get_device_engine()
        src, origin = eng._resident_source(loader, 0)
        sel = np.arange(len(eng._w))[np.isfinite(eng._w)]
        tab = eng._table_for_block(sel, (0, 0), origin, eng._w)
        cand = eng._cells_for_block(sel, (0, 0), 128, 128)
        return (src, t(tab[None]), t(cand[None]) if case == 'fold_cells'
                else None, 128, 128, True, 'u8')
    if case.startswith('mesh'):
        mesh = _p(_smooth_mesh(N=1024, mesh_size=40))
        loader = StreamLoader(_world(N=1024))
        eng = MeshRenderer.from_mesh(mesh, device=dev)._get_device_engine()
        src, origin = eng._resident_source(loader, 0)
        tb = eng._tb
        sel = np.nonzero((tb[:, 0] < 512) & (tb[:, 2] > 0) & (tb[:, 1] < 512)
                         & (tb[:, 3] > 0))[0]
        tab = eng._table_for_block(sel, (0, 0), origin, eng._w)
        cand = eng._cells_for_block(sel, (0, 0), 512, 512)
        if case == 'mesh_hole':
            cand[5] = tab.shape[0] - 1          # one cell: padding only
        if case == 'mesh_f32_source':
            src = src.to(torch.float32) * 0.5
        return (src, t(tab[None]), None if case == 'mesh_flat_chunks'
                else t(cand[None]), 512, 512, False,
                'f32' if case == 'mesh_f32_source' else 'u8')
    # random triangle tables (flat; any block size)
    kind, h, w = {'flat_1x1_u16': ('u16', 1, 1), 'flat_3x5_f32': ('f32', 3, 5),
                  'flat_130x70_u16': ('u16', 130, 70),
                  'flat_130x70_f32': ('f32', 130, 70),
                  'flat_corner_tile': ('u8', 256, 384),
                  'cells_k4': ('u8', 256, 256)}[case]
    if case == 'flat_corner_tile':
        P = rng.uniform(0, 1, (6, 3, 2)) * [100, 7] + [2, 0]
    elif case == 'cells_k4':
        P = np.array([[[-8, -8], [300, -8], [-8, 300]],
                      [[300, -8], [300, 300], [-8, 300]]], np.float64)
    else:
        P = np.concatenate([_random_triangles(rng, 20, h, w, 8),
                            [[[-5, -5], [40, -5], [-5, 40]]]])
    tab, P = _table_from_triangles(P, rng)
    cand = None
    if case == 'cells_k4':
        cand = _cells_from_triangles(P, h, w)
        assert cand.shape[-1] == 4
    return (t(_world(N=512)), t(tab[None]), None if cand is None
            else t(cand[None]), h, w, False, kind)


@pytest.mark.cuda
@pytest.mark.parametrize('interp', render.INTERPS)
@pytest.mark.parametrize('case', [
    'mesh_flat_chunks', 'mesh_cells', 'mesh_hole', 'mesh_f32_source',
    'fold_flat', 'fold_cells', 'flat_1x1_u16', 'flat_3x5_f32',
    'flat_130x70_u16', 'flat_130x70_f32', 'flat_corner_tile', 'cells_k4'])
def test_raster_kernel_matches_plain_on_card(case, interp):
    """The kernel is bit-equal to the plain version, coverage flags
    included, in both sampling modes, at the edges of its design: a flat
    table walked in chunks (more than 256 rows), cells with K = 64 and
    K = 4, a cell with only padding candidates, an f32 source, the geodesic
    mask, ragged flat blocks with u16 and f32 outputs, and real rows in one
    corner tile (its Lanczos-4 taps reaching past the source's edge)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    dev = device_mod.get_device('cuda')
    src, tabs, cands, h, w, geodesic, kind = _card_case(case, dev)
    if case == 'mesh_flat_chunks':
        assert tabs.shape[1] > 256
    if case == 'mesh_cells':
        assert cands.shape[-1] == 64
    got, cov = render.raster_blocks(src, tabs, cands, 7.0, h, w, geodesic,
                                    kind, interp=interp)
    want, pcov = render.raster_blocks_plain(src, tabs, cands, 7.0, h, w,
                                            geodesic, kind, interp=interp)
    assert got[0].dtype == want[0].dtype and cov.dtype == torch.bool
    assert torch.equal(got[0], want[0]) and torch.equal(cov, pcov)
