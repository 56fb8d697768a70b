"""The port's stacked window solve (parallel/window.py) and the lattice
stencil / incidence ops of ops/fem.py against the JAX package, f64 on both
sides, on the fixtures of tests/test_parallel.py. The port receives its own
meshes, rebuilt from the JAX meshes' init dicts (``state``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feabas_tpu.mesh import Mesh
from feabas_tpu.ops import fem as jfem
from feabas_tpu.parallel import window as jwin
from feabas_tpu_torch import state
from feabas_tpu_torch.ops import fem
from feabas_tpu_torch.parallel import window

# the tier-1 run shares the cores among several pytest workers
torch.set_num_threads(1)

F64 = torch.float64


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')


def _port_meshes(meshes):
    return [state.mesh_from_init_dict(m.get_init_dict()) for m in meshes]


def _links(meshes, drift, pts, extrapolate=False):
    out = []
    for z in range(len(meshes) - 1):
        d = drift[z + 1] - drift[z]
        tid0 = meshes[z].tri_finder(pts, gear='INITIAL', extrapolate=extrapolate)
        tid1 = meshes[z + 1].tri_finder(pts + d, gear='INITIAL',
                                        extrapolate=extrapolate)
        out.append({
            'idx0': meshes[z].triangles[tid0],
            'bary0': meshes[z].cart2bary(pts, tid0, gear='INITIAL'),
            'idx1': meshes[z + 1].triangles[tid1],
            'bary1': meshes[z + 1].cart2bary(pts + d, tid1, gear='INITIAL'),
            'weight': np.ones(len(pts))})
    return out


def _stack_inputs(S=8, cartesian=True, bbox=(0, 0, 100, 100), mesh_size=25,
                  sizes=None, seed=0, jitter=2.0, lock_first=True):
    """S sections (one topology, or one per entry of ``sizes``) linked by a
    known cumulative drift, as in test_parallel._make_stack. Returns
    (JAX meshes, links_per_pair, drift)."""
    rng = np.random.default_rng(seed)
    meshes = []
    for z in range(S):
        m = Mesh.from_bbox(bbox, cartesian=cartesian,
                           mesh_size=sizes[z] if sizes else mesh_size,
                           uid=z, name=f'z{z}')
        m.set_translation((0, 0))
        meshes.append(m)
    meshes[0].locked = lock_first
    drift = np.cumsum(rng.normal(0, jitter, (S, 2)), axis=0)
    drift -= drift[0]
    x0, y0, x1, y1 = bbox
    mx, my = 0.15 * (x1 - x0), 0.15 * (y1 - y0)
    xs, ys = np.meshgrid(np.linspace(x0 + mx, x1 - mx, 4),
                         np.linspace(y0 + my, y1 - my, 4))
    pts = np.stack([xs.ravel(), ys.ravel()], -1)
    return meshes, _links(meshes, drift, pts), drift


def _stack(**kw):
    meshes, links, drift = _stack_inputs(**kw)
    return window.build_stack_system(_port_meshes(meshes), links), drift


_KEYS = ('verts0', 'u', 'tris', 'multiplier', 'poisson', 'links', 'r_rest',
         'free')


def _jax_args(system):
    sys64 = state.cast_floats({k: system[k] for k in _KEYS}, np.float64)
    return [jnp.asarray(sys64[k]) if k != 'links'
            else tuple(jnp.asarray(a) for a in sys64[k]) for k in _KEYS]


def _port_args(system):
    t = state.to_tensors({k: system[k] for k in _KEYS}, torch.device('cpu'),
                         float_dtype=F64)
    return [t[k] for k in _KEYS]


def test_port_packs_the_same_system():
    for cartesian, sizes in ((True, None), (False, None),
                             (True, [28, 35, 40, 31])):
        meshes, links, _ = _stack_inputs(S=4, cartesian=cartesian,
                                         bbox=(0, 0, 300, 240), mesh_size=40,
                                         sizes=sizes)
        got = window.build_stack_system(_port_meshes(meshes), links)
        want = jwin.build_stack_system(meshes, links)
        assert set(got) == set(want)
        for k, v in want.items():
            if k == 'links':
                assert all(np.array_equal(a, b) for a, b in zip(got[k], v))
            elif k == 'verts0_host':
                assert all(np.array_equal(a, b) for a, b in zip(got[k], v))
            else:
                assert np.array_equal(np.asarray(got[k]), np.asarray(v)), k


@pytest.mark.parametrize('path', ['scatter', 'gather', 'stencil', 'linc'])
def test_stack_solve_matches_jax(path):
    """Single-device fixture of test_parallel (8 sections, first locked),
    through every matvec form the JAX stack_solve offers."""
    system, drift = _stack(S=8)
    kw = {}
    jkw = {}
    if path == 'gather':
        inc, mask = fem.build_incidence(np.asarray(system['tris']),
                                        system['u'].shape[1])
        kw = dict(inc=torch.as_tensor(inc), imask=torch.as_tensor(mask, dtype=F64))
        jkw = dict(inc=jnp.asarray(inc), imask=jnp.asarray(mask, jnp.float64))
    elif path in ('stencil', 'linc'):
        assert system.get('grid_shape') is not None
        kw = dict(grid_shape=system['grid_shape'],
                  sten=torch.as_tensor(system['sten']))
        jkw = dict(grid_shape=system['grid_shape'],
                   sten=jnp.asarray(system['sten']))
        if path == 'linc':
            lt = window.build_link_transpose(system['links'], 8,
                                             system['u'].shape[1])
            kw['linc'] = tuple(torch.as_tensor(a) for a in lt)
            jkw['linc'] = tuple(jnp.asarray(a) for a in lt)
    want, jit, _ = jwin.stack_solve(*_jax_args(system), lam_s=0.01,
                                    maxiter=800, **jkw)
    got, it, _ = window.stack_solve(*_port_args(system), lam_s=0.01,
                                    maxiter=800, **kw)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-6
    assert abs(int(it) - int(jit)) <= 1
    # and the drift is undone
    rm = system.get('real_mask')
    for z in range(8):
        rows = got[z].numpy()[rm] if rm is not None else got[z].numpy()
        assert np.abs(rows - (-drift[z])).max() < 0.15


def test_stack_solve_ragged_balanced_deflated():
    """A ragged stack (one topology per section) with no locked section:
    in-program lambda balance, rigid-mode deflation and the coarse
    preconditioner, against the JAX package."""
    system, drift = _stack(S=5, bbox=(0, 0, 120, 120),
                           sizes=[28, 35, 40, 31, 26], seed=3,
                           lock_first=False)
    assert np.asarray(system['tris']).ndim == 3
    assert system.get('grid_shape') is None
    modes = window.stack_rigid_modes(system)
    jmodes = jwin.stack_rigid_modes(system)
    assert modes is not None and np.abs(modes - jmodes).max() < 1e-12
    lt = window.build_link_transpose(system['links'], 5, system['u'].shape[1])
    jlt = jwin.build_link_transpose(system['links'], 5, system['u'].shape[1])
    assert all(np.array_equal(a, b) for a, b in zip(lt, jlt))
    want, _, _ = jwin.stack_solve(*_jax_args(system), lam_ratio=0.5,
                                  tol=1e-10, maxiter=600,
                                  modes=jnp.asarray(modes),
                                  linc=tuple(jnp.asarray(a) for a in lt))
    got, _, _ = window.stack_solve(*_port_args(system), lam_ratio=0.5,
                                   tol=1e-10, maxiter=600,
                                   modes=torch.as_tensor(modes),
                                   linc=tuple(torch.as_tensor(a) for a in lt))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-6
    dx = got.numpy() - system['u']
    assert np.abs(np.einsum('ksvc,svc->k', modes, dx)).max() < 1e-6


def test_stack_positions_and_padding():
    system, drift = _stack(S=6, cartesian=False, bbox=(0, 0, 300, 240),
                           mesh_size=40, seed=3)
    assert window.pad_stack_sections(system, 1) is system
    padded = window.pad_stack_sections(system, 4)
    jpadded = jwin.pad_stack_sections(system, 4)
    assert padded['u'].shape[0] == 8
    for k in ('u', 'free', 'multiplier', 'r_rest'):
        assert np.array_equal(padded[k], jpadded[k])
    u = np.random.default_rng(1).normal(0, 1, system['u'].shape)
    for a, b in zip(window.stack_positions(system, u),
                    jwin.stack_positions(system, u)):
        assert np.array_equal(a, b)


def test_lattice_ops_match_jax():
    """lattice_embedding, the stencil assembly gather, the stencil matvec
    and diagonal, and the incidence-gather matvec against the JAX
    package (and against the scatter matvec)."""
    rng = np.random.default_rng(7)
    for cartesian in (True, False):
        m = Mesh.from_bbox((0, 0, 300, 240), cartesian=cartesian,
                           mesh_size=40)
        verts = m.vertices_w_offset('INITIAL')
        tris = m.triangles
        emb = fem.lattice_embedding(verts, tris)
        jemb = jfem.lattice_embedding(verts, tris)
        assert emb is not None and np.array_equal(emb[0], jemb[0]) \
            and emb[1] == jemb[1]
        cell_of, (ny, nx) = emb
        V = ny * nx
        tris_c = cell_of[tris]
        sten = fem.build_stencil_assembly(tris_c, nx, V)
        assert np.array_equal(sten, jfem.build_stencil_assembly(tris_c, nx, V))
        verts_c = np.zeros((V, 2))
        verts_c[cell_of] = verts
        B, area2 = jfem.shape_matrices(jnp.asarray(verts_c[tris_c]))
        Ke = jfem.eng_element_stiffness(B, area2, jnp.ones(len(tris)),
                                        jnp.zeros(len(tris)))
        Ke_t = torch.as_tensor(np.asarray(Ke))
        C = fem.stencil_assemble_gather(Ke_t, torch.as_tensor(sten))
        jC = jfem.stencil_assemble_gather(Ke, jnp.asarray(sten))
        assert np.abs(C.numpy() - np.asarray(jC)).max() < 1e-12
        x = rng.normal(0, 1, (V, 2))
        y = fem.stiffness_matvec_stencil(torch.as_tensor(x), C, ny, nx)
        jy = jfem.stiffness_matvec_stencil(jnp.asarray(x), jC, ny, nx)
        assert np.abs(y.numpy() - np.asarray(jy)).max() < 1e-10
        ref = fem.stiffness_matvec(torch.as_tensor(x), Ke_t,
                                   torch.as_tensor(tris_c, dtype=torch.int64))
        assert np.abs(y.numpy() - ref.numpy()).max() < 1e-10
        d = fem.stencil_diag(C, V)
        assert np.abs(d.numpy() - np.asarray(jfem.stencil_diag(jC, V))).max() < 1e-12
        # a batch of two sections at once
        y2 = fem.stiffness_matvec_stencil(
            torch.as_tensor(np.stack([x, 2 * x])), torch.stack([C, C]), ny, nx)
        assert np.abs(y2[1].numpy() - 2 * y.numpy()).max() < 1e-10
        inc, mask = fem.build_incidence(tris_c, V)
        jinc, jmask = jfem.build_incidence(tris_c, V)
        assert np.array_equal(inc, jinc) and np.array_equal(mask, jmask)
        g = fem.stiffness_matvec_gather(
            torch.as_tensor(x), Ke_t, torch.as_tensor(tris_c, dtype=torch.int64),
            torch.as_tensor(inc, dtype=torch.int64), torch.as_tensor(mask, dtype=F64))
        assert np.abs(g.numpy() - ref.numpy()).max() < 1e-10
        tg = fem.stencil_targets(tris_c, nx, V)
        assert np.array_equal(tg, np.asarray(jfem.stencil_targets(tris_c, nx, V)))
