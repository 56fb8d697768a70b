"""The port's montage blend (ops/montage_render.py): the plain version
against the JAX package's ``montage_blend`` on the same inputs, the kernel's
cell cull held exact, first-wins ties, and the wrapper's dispatch. Blocks
are prepared by the port's own engine (``MontageDeviceEngine.block_inputs``)
from seeded tiles and tile meshes; the JAX function gets the same arrays."""

import os
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

from feabas_tpu.ops import montage_render as jmr
from feabas_tpu.utils.synthetic import texture
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch.ops import montage_render as mrd

# the tier-1 run shares the cores among several pytest workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')


def _smoke():
    """chip_smoke.py at the repo's root: its tile stack, tile meshes and
    phase-3 cases are what these tests build blocks from."""
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def _block(scene, blend, fillval=0.0, dev='cpu'):
    """``montage_blend`` args of one block of a seeded scene:
    seeded band-limited textures. 'dense': four 180 x 150 tiles (R > 128 rows each, gain/offset != (1, 0))
    around a 334 x 351 block whose cells hold 0 to 4 of them; 'tie': two
    tiles of one geometry and different images."""
    smoke = _smoke()
    rng = np.random.default_rng(7)
    if scene in ('dense', 'ragged'):
        origins = [(-20.3, -10.7), (90.6, -5.2), (-15.4, 80.1), (95.2, 85.9)]
        tiles = [texture(rng, 150, 180) for _ in origins]
        meshes = smoke.tile_meshes([(180, 150)] * 4, origins, 20,
                                   cartesian=True, shear=2e-3)
        transfers = [(1.0, 0.0), (1.1, -3.0), (0.9, 5.0), (1.05, 2.5)]
        bbox = ((-60.5, -50.3, 272.2, 299.6) if scene == 'dense'
                else (30.25, 20.5, 230.75, 171.5))
    elif scene == 'mesh':
        # one 320^2 tile on a 12-px cartesian mesh: more than 1000 rows
        origins = [(-3.5, 7.25)]
        tiles = [texture(rng, 320, 320)]
        meshes = smoke.tile_meshes([(320, 320)], origins, 12, cartesian=True)
        transfers = None
        bbox = (0, 0, 320, 320)
    elif scene == 'kcap':
        # K_CAP tiles of 64^2 over one corner, each its own gain / offset
        n = mrd.K_CAP
        origins = [(0.37 * i, 0.21 * i) for i in range(n)]
        tiles = [texture(rng, 64, 64) for _ in range(n)]
        meshes = smoke.tile_meshes([(64, 64)] * n, origins, 40)
        transfers = [(1.0 + 0.01 * i, i % 5 - 2.0) for i in range(n)]
        bbox = (0, 0, 192, 128)
    elif scene == 'turned':
        # a tile shown at half size and turned by 30 degrees
        origins = [(0.0, 0.0)]
        tiles = [texture(rng, 256, 256)]
        meshes = smoke.tile_meshes([(256, 256)], origins, 40, scale=0.5,
                                   turn=30.0)
        transfers = None
        bbox = (0, 0, 256, 256)
    else:
        origins = [(0, 0), (0, 0)]
        tiles = [texture(rng, 96, 128) for _ in origins]
        meshes = smoke.tile_meshes([(128, 96)] * 2, [(5.5, 3.25)] * 2, 30,
                                   cartesian=True)
        transfers = None
        bbox = (0, 0, 150, 120)
    args, H, W = smoke.montage_block(torch.device(dev), tiles, origins,
                                     meshes, bbox, blend, fillval, transfers)
    return args, H, W


def _jax(args):
    srcs, lows, gmap, tables, aux, cands, fillval, ncy, ncx, out_kind, \
        pyramid = args

    def u32(t):
        return jnp.asarray(t.numpy().view(np.uint32))
    out, cov = jmr.montage_blend(
        u32(srcs), u32(lows), jnp.asarray(gmap.numpy(), jnp.int32),
        jnp.asarray(tables.numpy()), jnp.asarray(aux.numpy()),
        jnp.asarray(cands.numpy(), jnp.int32), jnp.float32(fillval),
        ncy=ncy, ncx=ncx, out_kind=out_kind, pyramid=pyramid)
    return np.asarray(out), bool(cov)


@pytest.mark.parametrize('scene,fillval', [('dense', 0.0), ('dense', 17.0),
                                           ('tie', 0.0)])
@pytest.mark.parametrize('blend', ['LINEAR', 'PYRAMID'])
def test_plain_matches_jax(scene, fillval, blend):
    """The plain version against the JAX program: uint8 within 1 LSB on
    fewer than 1% of pixels (f32 rounding of the sums), equal covered
    flags. The dense block has tables of more than 128 rows (which the JAX
    package's engine sends to the host, not its blend), ragged H and W,
    cells with 0 to 4 candidates and gain/offset transfers."""
    args, H, W = _block(scene, blend, fillval)
    tables, cands = args[3], args[5]
    if scene == 'dense':
        assert tables.shape[1] > 128 and H % 64 and W % 64
        per_cell = (cands >= 0).sum(dim=1)
        assert per_cell.min() == 0 and per_cell.max() == 4
        assert not torch.equal(args[4][:, 3:], torch.tensor([[1.0, 0.0]] * 4))
    else:
        assert bool((cands[:, 1] == 1).any())
    got, cov = mrd.montage_blend_plain(*args)
    want, cov_j = _jax(args)
    assert cov == cov_j
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    if fillval:
        assert (got == 17).sum() > 64 * 64


def _raster_from_winners(tab, px, py, rows=None):
    """``mrd._raster_plain`` as the kernel splits it: each pixel's winning
    row (``winner_rows_plain``), then (sx, sy) recomputed from that row's
    affine with the same rounded ops."""
    win, score = mrd.winner_rows_plain(tab, px, py, rows)
    C = tab.shape[0]
    # (C, 6, CELL, CELL): the winning row's affine at each pixel
    m = torch.gather(
        tab[:, :, 6:12], 1,
        torch.clamp(win, min=0).reshape(C, -1, 1).expand(-1, -1, 6)
    ).reshape(C, mrd.CELL, mrd.CELL, 6).permute(0, 3, 1, 2)
    sx = mrd._affine_plain(m[:, 0], px, m[:, 1], py, m[:, 2])
    sy = mrd._affine_plain(m[:, 3], px, m[:, 4], py, m[:, 5])
    return score, sx, sy


@pytest.mark.parametrize('scene', ['dense', 'ragged', 'tie', 'kcap'])
@pytest.mark.parametrize('blend', ['LINEAR', 'PYRAMID'])
def test_blend_from_winner_rows_matches_jax(scene, blend, monkeypatch):
    """The kernel's split (each pixel's winning table row, then the source
    recomputed from that row's affine: ``winner_rows_plain``) blends as
    the JAX program does, to the rule of ``test_plain_matches_jax``, on
    blocks of up to K_CAP candidates a cell. (The JAX program unrolls
    every table row, so the 1000-row scene is held to the plain version
    alone, below, as is the turned tile.)"""
    args, _, _ = _block(scene, blend, 17.0 if scene == 'ragged' else 0.0)
    if scene == 'kcap':
        assert args[5].shape[1] == mrd.K_CAP
    monkeypatch.setattr(mrd, '_raster_plain', _raster_from_winners)
    got, cov = mrd.montage_blend_plain(*args)
    want, cov_j = _jax(args)
    assert cov == cov_j
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.mark.parametrize('scene', ['dense', 'ragged', 'tie', 'mesh', 'kcap',
                                   'turned'])
@pytest.mark.parametrize('blend', ['LINEAR', 'PYRAMID'])
def test_winner_rows_reproduce_the_plain_blend(scene, blend, monkeypatch):
    """Sampling from ``winner_rows_plain`` reproduces the plain version bit
    for bit (f32 output and covered flag); every winning row survives the
    cell cull (``cell_cull_plain``: the kernel rasters only those) and
    carries the tile's largest weight (every real row weighs 1 here)."""
    args, _, _ = _block(scene, blend)
    tables, cands, ncx = args[3], args[5], args[8]
    if scene == 'mesh':
        assert tables.shape[1] >= 1000
    f32 = args[:9] + ('f32',) + args[10:]
    want, cov = mrd.montage_blend_plain(*f32)
    with monkeypatch.context() as m:
        m.setattr(mrd, '_raster_plain', _raster_from_winners)
        got, cov_w = mrd.montage_blend_plain(*f32)
    assert torch.equal(got, want) and cov == cov_w
    C, K = cands.shape
    px, py = mrd._cell_grid(torch.arange(C), ncx, 'cpu')
    rows, weight = (torch.stack(t, dim=1) for t in zip(*(
        mrd.winner_rows_plain(tables[torch.clamp(cands[:, k], min=0)], px, py)
        for k in range(K))))
    live = (cands >= 0)[:, :, None, None]
    rows = torch.where(live, rows, -1)
    weight = torch.where(live, weight, -torch.inf)
    hit = rows >= 0
    assert bool(hit.any())
    assert torch.equal(hit, weight > -torch.inf)
    keep = mrd.cell_cull_plain(tables, cands, ncx)       # (C, K, R)
    kept = torch.gather(keep, 2, torch.clamp(rows, min=0).reshape(C, K, -1))
    assert bool(kept.reshape(rows.shape)[hit].all())
    top = tables[torch.clamp(cands, min=0), :, 12].amax(dim=2)   # (C, K)
    assert torch.equal(weight[hit], top[:, :, None, None].expand_as(
        weight)[hit])


def test_first_tile_wins_the_high_band():
    """Two tiles of one geometry, both given the first's low band: where
    both cover a pixel with equal weight, the first tile's high band wins,
    so the pair renders bit-equal to the first tile alone (f32 output) and
    not as the second alone."""
    args, _, _ = _block('tie', 'PYRAMID')
    srcs, lows, gmap, tables, aux, cands = args[:6]
    ncy, ncx = args[7:9]
    pair = mrd.montage_blend_plain(srcs, lows[[0, 0]], gmap, tables, aux,
                                   cands, 0.0, ncy, ncx, 'f32', True)[0]
    one = torch.where(cands == 0, 0, -1)[:, :1].contiguous()

    def alone(i):
        return mrd.montage_blend_plain(srcs[i:i + 1], lows[:1], gmap[:1],
                                       tables[:1], aux[:1], one, 0.0, ncy,
                                       ncx, 'f32', True)[0]
    assert torch.equal(pair, alone(0))
    assert not torch.equal(pair, alone(1))


@pytest.mark.parametrize('blend', ['LINEAR', 'PYRAMID'])
def test_cell_cull_leaves_the_output_bit_equal(blend):
    """The kernel's per-cell row cull drops most rows of the dense block,
    and the plain version limited to the surviving rows is bit-equal to
    the unculled one, covered flag included."""
    args, _, _ = _block('dense', blend)
    tables, cands, ncx = args[3], args[5], args[8]
    keep = mrd.cell_cull_plain(tables, cands, ncx)
    live = int((cands >= 0).sum()) * tables.shape[1]
    assert 0 < int(keep.sum()) < live // 2
    f32 = args[:9] + ('f32',) + args[10:]
    out, cov = mrd.montage_blend_plain(*f32)
    culled, cov_c = mrd.montage_blend_plain(*f32, rows=keep)
    assert torch.equal(out, culled) and cov == cov_c


def test_cell_cull_keeps_a_row_touching_a_cell_at_one_corner():
    """A triangle whose only pixel in cell 0 is its corner (63, 63) (vertex
    there, legs of 32 px: every coefficient exact in f32) survives cell 0's
    cull and renders that pixel; a far triangle is dropped there."""
    tab = np.zeros((3, 14), np.float32)
    tab[:, 2], tab[:, 12], tab[:, 13] = -2.0, -np.inf, -1.0
    # l1 = (x - 63) / 32, l2 = (y - 63) / 32; source = pixel - (40, 40)
    tab[0] = [1 / 32, 0, -63 / 32, 0, 1 / 32, -63 / 32,
              1, 0, -40, 0, 1, -40, 1, -1]
    tab[1] = tab[0]
    tab[1, [2, 5]] = -160 / 32                      # vertex at (160, 160)
    tables = torch.from_numpy(tab[None])
    cands = torch.zeros((9, 1), dtype=torch.int64)
    keep = mrd.cell_cull_plain(tables, cands, 3)
    assert keep[0, 0].tolist() == [True, False, False]
    assert keep[4, 0].tolist() == [True, False, False]
    assert keep[8, 0].tolist() == [False, True, False]
    src = torch.from_numpy(np.arange(256 * 256, dtype=np.int64).reshape(
        256, 256) % 251).to(torch.uint8)
    packed = mrd.pack_tile_stack(src[None])
    aux = torch.tensor([[256.0, 256.0, 4.0, 1.0, 0.0]])
    gmap = torch.zeros(1, dtype=torch.int64)
    args = (packed, packed, gmap, tables, aux, cands, 5.0, 3, 3, 'u8', False)
    out, cov = mrd.montage_blend_plain(*args)
    culled, cov_c = mrd.montage_blend_plain(*args, rows=keep)
    assert cov and cov_c and torch.equal(out, culled)
    assert int(out[63, 63]) == int(src[23, 23]) and int(out[63, 62]) == 5
    assert int(out[62, 63]) == 5


def test_covered_pixels_count_each_covering_tile():
    """The bound's sample count: two tiles of one geometry cover twice the
    pixels of the first alone."""
    args, _, _ = _block('tie', 'LINEAR')
    tables, cands, ncx = args[3], args[5], args[8]
    one = torch.where(cands == 0, 0, -1)[:, :1].contiguous()
    n1 = mrd.covered_pixels_plain(tables[:1], one, ncx)
    assert n1 > 0 and mrd.covered_pixels_plain(tables, cands, ncx) == 2 * n1


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors ``montage_blend`` is the plain version and launches
    nothing."""
    args, _, _ = _block('dense', 'PYRAMID')
    device_mod.reset_launch_counts()
    got, cov = mrd.montage_blend(*args)
    want, cov_p = mrd.montage_blend_plain(*args)
    assert torch.equal(got, want) and cov == cov_p
    assert device_mod.launch_counts()['montage_blend'] == 0


@pytest.mark.parametrize('fault', ['cands int32', 'short aux', 'out kind',
                                   'cands past the tables', 'cands below -1',
                                   'gmap past the stack', 'on the cpu'])
def test_kernel_checks_its_inputs(fault):
    """The kernel's wrapper raises, before any launch, on what the kernel
    does not take (indices it would read out of bounds at included), and
    on tensors that are not on the card."""
    args = list(_block('dense', 'PYRAMID')[0])
    T, N = args[3].shape[0], args[0].shape[0]
    if fault == 'cands past the tables':
        args[5] = args[5].clone()
        args[5][5, 0] = T
    elif fault == 'cands below -1':
        args[5] = args[5].clone()
        args[5][0, -1] = -2
    elif fault == 'gmap past the stack':
        args[2] = torch.full_like(args[2], N)
    elif fault == 'cands int32':
        args[5] = args[5].to(torch.int32)
    elif fault == 'short aux':
        args[4] = args[4][:, :4].contiguous()
    elif fault == 'out kind':
        args[9] = 'u16'
    with pytest.raises(ValueError, match='CUDA' if fault == 'on the cpu'
                       else 'cands|aux|out_kind|gmap'):
        mrd._prepare(*args)


def test_chip_check_rebuilds_the_blocks_the_stitch_cli_wrote(tmp_path,
                                                         monkeypatch):
    """chip_smoke.py holds the kernel against its plain version on the
    stitch path's own blocks, rebuilt from the work dir after the CLI ran
    (``stitch_blocks``): blended again, each is the image the rendering
    stage wrote."""
    import cv2
    from synthutil import tile_grid
    from test_torch_stitch import _make_workdir, _run_cli
    from feabas_tpu_torch import config
    from feabas_tpu_torch.scripts import stitch_main
    smoke = _smoke()
    rng = np.random.default_rng(42)
    _, tiles, _, stage_bb = tile_grid(rng, rows=2, cols=2, tile_h=300,
                                      tile_w=400, overlap=270, jitter=3.0)
    cfg, wd = _make_workdir(str(tmp_path), tiles, stage_bb,
                            {'device': {'render': True}})
    _run_cli(stitch_main.main, cfg, monkeypatch)
    out_dir = os.path.join(wd, 'stitched_sections', 'mip0', 's0001')
    config.clear_config_caches()
    try:
        blocks = list(smoke.stitch_blocks(wd))
    finally:
        config.clear_config_caches()
    assert len(blocks) == len([f for f in os.listdir(out_dir)
                               if f.endswith('.png')]) > 0
    for fname, _, blend, args, H, W in blocks:
        assert blend == 'PYRAMID'
        got, cov = mrd.montage_blend(*args)
        want = cv2.imread(os.path.join(out_dir, fname), cv2.IMREAD_UNCHANGED)
        assert cov and np.array_equal(got[:H, :W].numpy(), want), fname


@pytest.mark.cuda
@pytest.mark.parametrize('case', [
    '4096^2 LINEAR', 'ragged 1338 x 1000, PYRAMID',
    'ragged 1338 x 1000, LINEAR, f32 out', 'cells without a tile, fill 17',
    'no tile in any cell, fill 17', 'identical tiles, the first wins',
    'dense mesh, R >= 1000', 'K = K_CAP',
    'tile scaled by 0.5, turned by 30 degrees', 'one cell, 64 x 64',
    'cells not a multiple of the grid'])
def test_kernel_matches_plain_on_card(case):
    """The kernel bit-equal to the plain version with the expected covered
    flag, over chip_smoke.py's phase-3 cases, each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    smoke = _smoke()
    cases = dict(smoke.montage_cases(torch.device('cuda')))
    before = device_mod.launch_counts()['montage_blend']
    smoke.montage_compare(cases[case]())
    assert device_mod.launch_counts()['montage_blend'] == before + 1
