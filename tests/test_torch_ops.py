"""The port's warp, xcorr and FEM operators against their JAX
counterparts on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feabas_tpu.ops import fem as jfem
from feabas_tpu.ops import warp as jwarp
from feabas_tpu.ops import xcorr as jxcorr
from feabas_tpu.utils.synthetic import texture
from feabas_tpu_torch.ops import fem, warp, xcorr

# the tier-1 run shares the cores among several pytest workers: one torch
# thread per worker avoids oversubscription
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------- warp ---------------------------------- #

def test_bilinear_sample_matches_jax(rng):
    img = rng.random((20, 30)).astype(np.float32) * 100
    xs = rng.uniform(-2, 31, (50,)).astype(np.float32)
    ys = rng.uniform(-2, 21, (50,)).astype(np.float32)
    xs[:3] = [29.0, 0.0, 29.0]                      # clamped-base edge rule
    ys[:3] = [19.0, 19.0, 0.0]
    want = np.asarray(jwarp.bilinear_sample(jnp.asarray(img), xs, ys, 0.0))
    got = warp.bilinear_sample(_t(img), _t(xs), _t(ys)).numpy()
    # f32 bilinear arithmetic, same formula
    assert np.abs(got - want).max() < 1e-4


def _block_affines(rng, n):
    A = np.eye(2)[None] + rng.normal(0, 0.01, (n, 2, 2))
    b = rng.uniform(-3, 3, (n, 2))
    origins = np.round(rng.uniform(-10, 60, (n, 2)))
    return origins.astype(np.float32), A.astype(np.float32), b.astype(np.float32)


def test_shifted_warp_matches_jax(rng):
    img = texture(rng, 80, 96)
    origins, A, b = _block_affines(rng, 6)
    want = np.asarray(jwarp.affine_warp_blocks_shifted(
        jnp.asarray(img), origins, A, b, 24, 24, 3))
    got = warp.affine_warp_blocks_shifted(_t(img), _t(origins), _t(A), _t(b),
                                          24, 24, 3).numpy()
    # the window sum vs a direct sample: same taps, f32 sum order (u8 px)
    assert np.abs(got - want).max() < 1e-3


def test_packed_sample_matches_jax(rng):
    img = rng.integers(0, 255, (16, 24)).astype(np.uint8)
    xs = rng.uniform(-1, 24, (40,)).astype(np.float32)
    ys = rng.uniform(-1, 16, (40,)).astype(np.float32)
    pk_j = jwarp.pack_u8_quads(jnp.asarray(img))
    want = np.asarray(jwarp.bilinear_sample_packed(pk_j, xs, ys))
    pk = warp.pack_u8_quads(_t(img))
    assert np.array_equal(pk.numpy().view(np.uint32), np.asarray(pk_j))
    got = warp.bilinear_sample_packed(pk, _t(xs), _t(ys)).numpy()
    assert np.abs(got - want).max() < 1e-4


# ---------------------------------- xcorr --------------------------------- #

def _shifted_blocks(rng, n=4, size=48):
    """Block pairs whose content is offset by known subpixel shifts."""
    import cv2
    big = texture(rng, size + 40, size + 40).astype(np.float32)
    b0, b1, shifts = [], [], []
    for _ in range(n):
        d = rng.uniform(-4, 4, 2)
        M = np.float32([[1, 0, d[0]], [0, 1, d[1]]])
        moved = cv2.warpAffine(big, M, big.shape[::-1], flags=cv2.INTER_CUBIC)
        b0.append(big[20:20 + size, 20:20 + size])
        b1.append(moved[20:20 + size, 20:20 + size])
        shifts.append(d)
    return np.stack(b0), np.stack(b1), np.asarray(shifts)


@pytest.mark.parametrize('subpixel', [False, True, 4])
def test_peak_and_subpixel_matches_jax(rng, subpixel):
    b0, b1, _ = _shifted_blocks(rng)
    fft = (128, 128)
    g0 = np.asarray(jxcorr.jnp.fft.rfft2(jnp.asarray(b0), s=fft))
    g1 = np.asarray(jxcorr.jnp.fft.rfft2(jnp.asarray(b1), s=fft))
    Fc = (np.conj(g0) * g1).astype(np.complex64)
    C = np.fft.irfft2(Fc, s=fft).astype(np.float32)
    Mk = np.fft.rfft2(np.ones((1, 48, 48), np.float32), s=fft)
    Nc = (np.conj(Mk) * Mk).astype(np.complex64)
    jd = jxcorr._peak_and_subpixel(jnp.asarray(C), fft, subpixel,
                                   Fc=jnp.asarray(Fc), Nc=jnp.asarray(Nc))
    td = xcorr._peak_and_subpixel(_t(C), fft, subpixel, Fc=_t(Fc), Nc=_t(Nc))
    for j, t in zip(jd[:2], td[:2]):
        # f32 peak fits / f32 DFT matmuls: well under the 0.1 px parity bound
        assert np.abs(np.asarray(j) - t.numpy()).max() < 1e-3


def test_xcorr_fft_displacement_matches_jax(rng):
    b0, b1, shifts = _shifted_blocks(rng, n=6)
    want = jxcorr.xcorr_fft(b0, b1, sigma=2.5, subpixel=True)
    got = xcorr.xcorr_fft(b0, b1, sigma=2.5, subpixel=True)
    for w, g in zip(want, got):
        assert np.abs(np.asarray(w) - g).max() < 1e-3
    # and the displacement is the true shift
    assert np.abs(got[0] - shifts[:, 0]).max() < 0.3
    assert np.abs(got[1] - shifts[:, 1]).max() < 0.3


# ----------------------------------- fem ---------------------------------- #

def _grid_mesh(nx, ny):
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny))
    verts = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float64) * 7.0
    tris = []
    for j in range(ny - 1):
        for i in range(nx - 1):
            v0 = j * nx + i
            tris.append([v0, v0 + 1, v0 + nx])
            tris.append([v0 + 1, v0 + nx + 1, v0 + nx])
    return verts, np.asarray(tris, np.int64)


def _system(rng, nx=5, ny=4):
    verts, tris = _grid_mesh(nx, ny)
    nv = len(verts)
    mult = rng.uniform(0.5, 2, len(tris))
    nu = rng.uniform(0, 0.3, len(tris))
    L = 6
    half = nv // 2
    idx0 = np.stack([rng.permutation(half)[:3] for _ in range(L)])
    idx1 = np.stack([half + rng.permutation(nv - half)[:3] for _ in range(L)])
    b0 = rng.random((L, 3))
    b0 /= b0.sum(1, keepdims=True)
    b1 = rng.random((L, 3))
    b1 /= b1.sum(1, keepdims=True)
    w = rng.random(L) + 0.5
    return verts, tris, mult, nu, (idx0, b0, idx1, b1, w)


def _jax_ke(verts, tris, mult, nu):
    B, a2 = jfem.shape_matrices(jnp.asarray(verts[tris]))
    return jfem.eng_element_stiffness(B, a2, jnp.asarray(mult), jnp.asarray(nu))


def _torch_ke(verts, tris, mult, nu):
    B, a2 = fem.shape_matrices(_t(verts[tris]))
    return fem.eng_element_stiffness(B, a2, _t(mult), _t(nu))


def test_element_stiffness_and_matvecs_match_jax(rng):
    verts, tris, mult, nu, links = _system(rng)
    nv = len(verts)
    Kj = _jax_ke(verts, tris, mult, nu)
    Kt = _torch_ke(verts, tris, mult, nu)
    # both in f64 here: agreement to rounding
    assert np.allclose(Kt.numpy(), np.asarray(Kj), atol=1e-10)
    x = rng.normal(0, 1, (nv, 2))
    assert np.allclose(fem.stiffness_matvec(_t(x), Kt, _t(tris)).numpy(),
                       np.asarray(jfem.stiffness_matvec(jnp.asarray(x), Kj,
                                                        jnp.asarray(tris))),
                       atol=1e-10)
    assert np.allclose(fem.stiffness_diag(Kt, _t(tris), nv).numpy(),
                       np.asarray(jfem.stiffness_diag(Kj, jnp.asarray(tris), nv)),
                       atol=1e-10)
    jl = [jnp.asarray(a) for a in links]
    tl = [_t(a) for a in links]
    assert np.allclose(fem.crosslink_matvec(_t(x), *tl).numpy(),
                       np.asarray(jfem.crosslink_matvec(jnp.asarray(x), *jl)),
                       atol=1e-10)
    assert np.allclose(
        fem.crosslink_diag(nv, *tl, dtype=torch.float64).numpy(),
        np.asarray(jfem.crosslink_diag(nv, *jl, dtype=jnp.float64)), atol=1e-10)


@pytest.mark.parametrize('chances', [None, 5])
def test_cg_solve_matches_jax(rng, chances):
    verts, tris, mult, nu, links = _system(rng)
    nv = len(verts)
    Kj = _jax_ke(verts, tris, mult, nu)
    Kt = _torch_ke(verts, tris, mult, nu)
    jl = [jnp.asarray(a) for a in links]
    tl = [_t(a) for a in links]
    b = rng.normal(0, 1, (nv, 2))
    # anchor a few vertices so the system is SPD
    anchor = np.zeros((nv, 2))
    anchor[[0, nv - 1, nv // 2]] = 5.0

    def mv_j(x):
        return (jfem.stiffness_matvec(x, Kj, jnp.asarray(tris))
                + jfem.crosslink_matvec(x, *jl) + jnp.asarray(anchor) * x)

    def mv_t(x):
        return (fem.stiffness_matvec(x, Kt, _t(tris))
                + fem.crosslink_matvec(x, *tl) + _t(anchor) * x)

    dj = (jfem.stiffness_diag(Kj, jnp.asarray(tris), nv)
          + jfem.crosslink_diag(nv, *jl, dtype=jnp.float64) + anchor)
    dt = (fem.stiffness_diag(Kt, _t(tris), nv)
          + fem.crosslink_diag(nv, *tl, dtype=torch.float64) + _t(anchor))
    xj, itj, rj = jfem.cg_solve(mv_j, jnp.asarray(b), diag=dj, tol=1e-10,
                                maxiter=500, chances=chances)
    xt, itt, rt = fem.cg_solve(mv_t, _t(b), diag=dt, tol=1e-10, maxiter=500,
                               chances=chances)
    # f64 on both sides: the same iterations, solutions equal to rounding
    assert int(itt) == int(itj)
    assert np.allclose(xt.numpy(), np.asarray(xj), atol=1e-8)
    assert abs(float(rt) - float(rj)) <= 1e-8 * max(1.0, float(rj))


def test_batched_cg_solves_each_system_alone(rng):
    verts, tris, mult, nu, links = _system(rng)
    nv = len(verts)
    Kt = _torch_ke(verts, tris, mult, nu)
    tl = [_t(a) for a in links]
    scales = [1.0, 30.0]

    def mv(x, s):
        return s * fem.stiffness_matvec(x, Kt, _t(tris)) + fem.crosslink_matvec(x, *tl) + x

    bs = [rng.normal(0, 1, (nv, 2)) for _ in scales]
    singles = [fem.cg_solve(lambda x, s=s: mv(x, s), _t(b), tol=1e-9,
                            maxiter=300) for s, b in zip(scales, bs)]
    xb, itb, _ = fem.cg_solve(
        lambda X: torch.stack([mv(X[i], s) for i, s in enumerate(scales)]),
        torch.stack([_t(b) for b in bs]), tol=1e-9, maxiter=300)
    for i, (x, it, _) in enumerate(singles):
        assert int(itb[i]) == int(it)
        assert np.allclose(xb[i].numpy(), x.numpy(), atol=1e-12)


# ------------------------------ montage blend ------------------------------ #

@pytest.mark.parametrize('pyramid', [False, True])
def test_montage_blend_matches_jax(rng, pyramid):
    from feabas_tpu import constant as const
    from feabas_tpu.mesh import Mesh
    from feabas_tpu.ops import montage_render as jmr
    from feabas_tpu_torch import state
    from feabas_tpu_torch.ops import montage_render as tmr
    H = W = 128
    tiles = rng.integers(0, 255, (2, 96, 112)).astype(np.uint8)
    tabs = []
    for k, (x0, y0) in enumerate([(3.3, 5.7), (70.6, 20.2)]):
        m = Mesh.from_bbox((0, 0, 112, 96), cartesian=True, mesh_size=40, uid=k)
        m.set_translation((x0, y0), gear=(const.MESH_GEAR_INITIAL,
                                          const.MESH_GEAR_MOVING))
        tt = tmr._TileTable(state.mesh_from_init_dict(m.get_init_dict()),
                            const.MESH_GEAR_MOVING, const.MESH_GEAR_INITIAL)
        tabs.append(tt.table_for_block(np.arange(len(m.triangles)), (0, 0)))
    R = max(t.shape[0] for t in tabs)
    tables = np.zeros((2, R, 14), np.float32)
    tables[:, :, 2] = -2.0
    tables[:, :, 12] = -np.inf
    tables[:, :, 13] = -1.0
    for k, t in enumerate(tabs):
        tables[k, :t.shape[0]] = t
    aux = np.float32([[112, 96, 7.0, 1.0, 0.0], [112, 96, 7.0, 1.1, -3.0]])
    ncy, ncx = H // tmr.CELL, W // tmr.CELL
    cands = np.full((ncy * ncx, 2), -1, np.int64)
    cands[:, 0] = 0
    cands[1:, 1] = 1                               # cell 0 sees tile 0 only
    gmap = np.arange(2)
    pk_j = jmr.pack_tile_stack(jnp.asarray(tiles))
    low_j = jmr.pack_low_stack(pk_j, jnp.asarray(aux[:, :2]), 4.0) if pyramid else pk_j
    want, cov_j = jmr.montage_blend(pk_j, low_j, jnp.asarray(gmap, jnp.int32),
                                    jnp.asarray(tables), jnp.asarray(aux),
                                    jnp.asarray(cands, jnp.int32),
                                    jnp.float32(0), ncy=ncy, ncx=ncx,
                                    pyramid=pyramid)
    pk = tmr.pack_tile_stack(_t(tiles))
    low = tmr.pack_low_stack(pk, _t(aux[:, :2]), 4.0) if pyramid else pk
    got, cov = tmr.montage_blend(pk, low, _t(gmap), _t(tables), _t(aux),
                                 _t(cands), 0.0, ncy, ncx, pyramid=pyramid)
    assert cov == bool(cov_j)
    # uint8 output: rounding of f32 sums may differ by one level
    diff = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
