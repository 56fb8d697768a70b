"""The port's nonlinear-material elastic solve against the JAX package, f64
on both sides: the element math (ENG, SVK, NHK, the stiffness curve), the
general CG operator (plain version, its kernel's tables), the general
``optimize_linear`` path, the grouped solve, Newton-Raphson with its flip
guard, ``coarse_mesh_SLM``, ``Mesh.anneal`` and the small Link / SLM
methods. The port receives its own meshes, rebuilt from the JAX meshes'
init dicts (``state``)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the JAX package's storage imports h5py at load; on a host without it
# the port's standard-HDF5 subset stands in for it in this test process
try:
    import h5py  # noqa: F401
except ImportError:
    from feabas_tpu_torch import _h5lite
    sys.modules['h5py'] = _h5lite

from feabas_tpu import constant as jconst
from feabas_tpu import optimizer as jopt
from feabas_tpu.material import Material, MaterialTable
from feabas_tpu.mesh import Mesh
from feabas_tpu.ops import fem as jfem
from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch import optimizer as popt
from feabas_tpu_torch import state
from feabas_tpu_torch.ops import fem

# the tier-1 run shares the cores among several pytest workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
# element math: the same f64 operations in another order
ELEMENT_RTOL = 1e-10
# solves: both packages run the same CG in f64 to tol 1e-10
LINEAR_PX = 1e-6
NEWTON_PX = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _close(got, want, rtol=ELEMENT_RTOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rtol * scale, \
        float(np.abs(got - want).max()) / scale


# ------------------------------- elements ------------------------------- #

def _elements(rng, n=4, amp=0.05):
    tripts = rng.normal(0, 3, (n, 3, 2))
    uv = amp * rng.normal(0, 1, (n, 6))
    mult = rng.uniform(0.5, 2.0, n)
    nu = rng.uniform(0.0, 0.4, n)
    return tripts, uv, mult, nu


def test_deformation_gradient_and_stress_match_jax(rng):
    tripts, uv, mult, nu = _elements(rng)
    Bj, a2j = jfem.shape_matrices(jnp.asarray(tripts))
    B, a2 = fem.shape_matrices(_t(tripts))
    _close(fem.deformation_gradient(B, _t(uv)),
           jfem.deformation_gradient(Bj, jnp.asarray(uv)))
    _close(fem.area_stretch(B, _t(uv)), jfem.area_stretch(Bj, jnp.asarray(uv)))
    Ke = fem.eng_element_stiffness(B, a2, _t(mult), _t(nu))
    Kj = jfem.eng_element_stiffness(Bj, a2j, jnp.asarray(mult),
                                    jnp.asarray(nu))
    _close(fem.eng_element_stress(Ke, _t(uv)),
           jfem.eng_element_stress(Kj, jnp.asarray(uv)))
    tris = np.array([[0, 1, 2], [2, 3, 0], [1, 3, 4], [4, 0, 2]])
    x = rng.normal(0, 1, (5, 2))
    _close(fem.stiffness_force(_t(x), Ke, torch.as_tensor(tris)),
           jfem.stiffness_force(jnp.asarray(x), Kj, jnp.asarray(tris)))


@pytest.mark.parametrize('model', ['svk', 'nhk'])
@pytest.mark.parametrize('amp', [0.0, 0.05, 0.2])
def test_nonlinear_elements_match_jax(model, amp, rng):
    tripts, uv, mult, nu = _elements(rng, amp=amp)
    Bj, a2j = jfem.shape_matrices(jnp.asarray(tripts))
    B, a2 = fem.shape_matrices(_t(tripts))
    if model == 'svk':
        got = fem.svk_element(B, a2, _t(uv), _t(mult), _t(nu))
        want = jfem.svk_element(Bj, a2j, jnp.asarray(uv), jnp.asarray(mult),
                                jnp.asarray(nu))
    else:
        got = fem.nhk_element(B, a2, _t(uv), _t(mult))
        want = jfem.nhk_element(Bj, a2j, jnp.asarray(uv), jnp.asarray(mult))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_svk_linearizes_to_eng(rng):
    tripts, _, mult, nu = _elements(rng, n=3)
    B, a2 = fem.shape_matrices(_t(tripts))
    K_eng = fem.eng_element_stiffness(B, a2, _t(mult), _t(nu))
    K_svk, P_svk = fem.svk_element(B, a2, torch.zeros((3, 6), dtype=F64),
                                   _t(mult), _t(nu))
    _close(K_svk, K_eng)
    assert float(P_svk.abs().max()) < 1e-12


@pytest.mark.parametrize('model', ['eng', 'svk', 'nhk'])
def test_tangent_is_force_jacobian(model, rng):
    """Ke is the Jacobian of Pe with respect to uv at a deformed state
    (``torch.autograd``)."""
    tripts, uv, mult, nu = _elements(rng, n=1, amp=0.1)
    B, a2 = fem.shape_matrices(_t(tripts))
    m, p = _t(mult), _t(nu)

    def terms(uv):
        if model == 'eng':
            Ke = fem.eng_element_stiffness(B, a2, m, p)
            return Ke, fem.eng_element_stress(Ke, uv)
        if model == 'svk':
            return fem.svk_element(B, a2, uv, m, p)
        return fem.nhk_element(B, a2, uv, m)

    Ke, _ = terms(_t(uv))
    jac = torch.autograd.functional.jacobian(
        lambda v: terms(v.reshape(1, 6))[1].reshape(6), _t(uv).reshape(6))
    _close(jac, Ke[0].detach().numpy())


def test_nhk_zero_at_rest(rng):
    tripts, _, mult, _ = _elements(rng, n=2)
    B, a2 = fem.shape_matrices(_t(tripts))
    _, P = fem.nhk_element(B, a2, torch.zeros((2, 6), dtype=F64), _t(mult))
    assert float(P.abs().max()) < 1e-12


def _wrinkle_knots():
    """The shipped 'wrinkle' material's knots, as the solver gets them."""
    mt = MaterialTable.from_pickleable(
        os.path.join(REPO, 'configs', 'default_material_table.yaml'))
    return mt['wrinkle'].stiffness_curve_knots()


def test_stiffness_curve_interp():
    """jnp.interp's rule on the shipped curve (knots 0, 0.75, 1.0, 1.01
    padded to 16): J on every knot takes that knot's value, J outside
    both ends the end values, J between knots the linear blend."""
    kx, ky = _wrinkle_knots()
    kx64, ky64 = kx.astype(np.float64), ky.astype(np.float64)
    J = np.concatenate([kx64, [-1.0, -1e-9, 0.3, 0.9, 0.999, 1.005, 1.5,
                               kx64[-1] + 1e-9, 50.0]])
    got = fem.stiffness_curve_multiplier(_t(J), _t(kx64), _t(ky64))
    want = jfem.stiffness_curve_multiplier(jnp.asarray(J), jnp.asarray(kx64),
                                           jnp.asarray(ky64))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy()[:kx.size], ky64)
    assert got[kx.size] == ky64[0] and got[-1] == ky64[-1]
    assert np.allclose(got.numpy(), np.interp(J, kx64, ky64), rtol=1e-15)
    # f32, the card's type: on-knot values exact too
    got32 = fem.stiffness_curve_multiplier(torch.as_tensor(kx),
                                           torch.as_tensor(kx),
                                           torch.as_tensor(ky))
    assert np.array_equal(got32.numpy(), ky)


# ------------------------------ the operator ------------------------------ #

def _operator_system(rng, n_groups, n_links, untouched=False, hub=0):
    """Two cartesian meshes' elements split into ``n_groups`` groups, a
    flat list of links between them, a free mask, (``untouched``) one
    extra vertex no element or link touches, and (``hub``) that many more
    links from the first triangle, whose corners then have more entries
    than 4 x 32 lanes."""
    nx = 5
    v, t = [], []
    for k in range(2):
        xs, ys = np.meshgrid(np.arange(nx), np.arange(nx))
        v.append(np.stack([xs.ravel(), ys.ravel()], -1) * 10.0
                 + [40.0 * k, 3.0 * k])
        for j in range(nx - 1):
            for i in range(nx - 1):
                a = k * nx * nx + j * nx + i
                t += [[a, a + 1, a + nx], [a + 1, a + nx + 1, a + nx]]
    verts = np.concatenate(v)
    tris = np.asarray(t)
    nv = verts.shape[0] + int(untouched)
    tripts = np.concatenate([verts, np.zeros((int(untouched), 2))])[tris]
    cuts = np.sort(rng.choice(np.arange(1, len(tris)), n_groups - 1,
                              replace=False))
    groups = np.split(np.arange(len(tris)), cuts)
    n0 = nx * nx
    idx0 = np.concatenate([rng.integers(0, len(tris) // 2, n_links),
                           np.zeros(hub, int)])
    n_links += hub
    idx1 = rng.integers(len(tris) // 2, len(tris), n_links)
    bary0 = rng.dirichlet(np.ones(3), n_links)
    bary1 = rng.dirichlet(np.ones(3), n_links)
    free = np.ones((nv, 1))
    free[:n0 // 2] = 0.0
    return dict(nv=nv, tris=tris, tripts=tripts, groups=groups,
                mult=rng.uniform(0.5, 2.0, len(tris)),
                nu=rng.uniform(0.0, 0.4, len(tris)),
                idx0=tris[idx0], bary0=bary0, idx1=tris[idx1], bary1=bary1,
                weight=rng.uniform(0.2, 1.0, n_links), free=free,
                x=rng.normal(0, 1, (nv, 2)))


def _jax_matvec_full(s, Kes, lam_s, lam_c):
    """The JAX package's matvec_full (optimizer.py:1192) without the
    rigid-mode projection: free (sum_g lam_s K_g x + lam_c C^T W^2 C x)."""
    x = jnp.asarray(s['x']) * jnp.asarray(s['free'])
    y = jnp.zeros_like(x)
    for g, Ke in zip(s['groups'], Kes):
        y = y + jfem.stiffness_matvec(x, Ke, jnp.asarray(s['tris'][g])) * lam_s
    y = y + jfem.crosslink_matvec(
        x, jnp.asarray(s['idx0']), jnp.asarray(s['bary0']),
        jnp.asarray(s['idx1']), jnp.asarray(s['bary1']),
        jnp.asarray(s['weight'])) * lam_c
    return np.asarray(y * jnp.asarray(s['free']))


def _tables(s, device='cpu', dtype=F64):
    """``fem.operator_tables`` over the system's element corners and
    links, on ``device``, barycentric weights in ``dtype``."""
    def idx(a):
        return torch.as_tensor(a, device=device)

    def bary(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return fem.operator_tables(idx(s['tris']), s['nv'], idx(s['idx0']),
                               bary(s['bary0']), idx(s['idx1']),
                               bary(s['bary1']))


def _numpy(tables):
    return {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in tables.items()}


def _port_operator_inputs(s):
    B, a2 = fem.shape_matrices(_t(s['tripts']))
    Ke = fem.eng_element_stiffness(B, a2, _t(s['mult']), _t(s['nu']))
    return Ke, _tables(s)


@pytest.mark.parametrize('n_groups,n_links,untouched', [
    (1, 12, False), (3, 12, False), (3, 0, False), (1, 7, True),
    (3, 30, True)])
def test_operator_plain_matches_jax_matvec(rng, n_groups, n_links,
                                           untouched):
    s = _operator_system(rng, n_groups, n_links, untouched)
    Bj, a2j = jfem.shape_matrices(jnp.asarray(s['tripts']))
    Kj = jfem.eng_element_stiffness(Bj, a2j, jnp.asarray(s['mult']),
                                    jnp.asarray(s['nu']))
    want = _jax_matvec_full(s, [Kj[g] for g in s['groups']], 0.37, 1.3)
    Ke, tables = _port_operator_inputs(s)
    x = _t(s['x']) * _t(s['free'])
    args = (x, Ke, tables, _t(s['weight']), _t(s['free']), 0.37, 1.3)
    got = fem.elastic_operator_plain(*args)
    _close(got, want)
    if untouched:
        assert float(got[-1].abs().max()) == 0.0
    # CPU tensors take the plain version and launch nothing
    device_mod.reset_launch_counts()
    assert torch.equal(fem.bind_elastic_operator(*args[1:])(x), got)
    assert device_mod.launch_counts()['fem_operator'] == 0


# csrc/fem_operator.cu's threads a block
KERNEL_THREADS = 128
# the operator's cases: (n_groups, n_links, untouched, hub); a vertex no
# entry touches, L = 0, a vertex with more entries than 4 x 32 lanes, and
# NV (50 or 51) a multiple of no G's vertices a block (128 / G)
OPERATOR_CASES = [(1, 12, False, 0), (3, 0, True, 0), (3, 30, True, 0),
                  (2, 20, False, 150)]


def _lane_operator(x, Ke, t, weight, free, lam_s, lam_c, group):
    """What the kernel computes, thread by thread: vertex gid // G of
    thread gid over whole blocks of KERNEL_THREADS, lane gid % G summing the
    vertex's element entries lane, lane + G, ... then its link entries
    (each times its link's weighted residual), read through the CSR tables as
    csrc/fem_operator.cu reads them; the G partial sums meet in the
    kernel's fixed xor butterfly. Checks that the grid writes every vertex
    once."""
    x, Ke, weight, free = (np.asarray(a) for a in (x, Ke, weight, free))
    tris, b0, b1 = t['tris'], t['bary0'], t['bary1']
    i0, i1 = t['idx0'], t['idx1']
    nv = x.shape[0]
    n_threads = -(-nv * group // KERNEL_THREADS) * KERNEL_THREADS
    y = np.full_like(x, np.nan)
    for v in range(n_threads // group):
        part = np.zeros((group, 4))          # kx, ky, cx, cy a lane
        for lane in range(group):
            if v >= nv:
                break
            inc = t['inc_ent'][t['inc_ptr'][v]:t['inc_ptr'][v + 1]]
            for f in inc[lane::group]:
                e, c = divmod(int(f), 3)
                u = x[tris[e]].ravel()
                part[lane, :2] += Ke[e, 2 * c:2 * c + 2] @ u
            lnk = t['lnk_ent'][t['lnk_ptr'][v]:t['lnk_ptr'][v + 1]]
            for f in lnk[lane::group]:
                lk, side = divmod(int(f), 2)
                l, kk = divmod(lk, 3)
                r = (b1[l] @ x[i1[l]] - b0[l] @ x[i0[l]]) * weight[l] ** 2
                part[lane, 2:] += (b1[l, kk] if side else -b0[l, kk]) * r
        o = group // 2
        while o:
            part = part + part[np.arange(group) ^ o]
            o //= 2
        assert np.all(part == part[0])       # every lane ends equal
        if v < nv:
            assert np.isnan(y[v]).all()
            y[v] = free[v] * (lam_s * part[0, :2] + lam_c * part[0, 2:])
    assert not np.isnan(y).any()
    return y


@pytest.mark.parametrize('group', [4, 8, 32])
@pytest.mark.parametrize('n_groups,n_links,untouched,hub', OPERATOR_CASES)
def test_operator_tables_give_the_plain_operator(rng, n_groups, n_links,
                                                 untouched, hub, group):
    """The kernel's CSR tables: each vertex's entries ascending, every
    element corner and link point listed once, and the lane-strided sums
    and butterfly of G lanes a vertex through them equal to the plain
    version."""
    s = _operator_system(rng, n_groups, n_links, untouched, hub)
    n_links += hub
    host = _numpy(_tables(s))
    for ptr, ent, n in (('inc_ptr', 'inc_ent', s['tris'].size),
                        ('lnk_ptr', 'lnk_ent', 6 * n_links)):
        assert host[ptr][0] == 0 and host[ptr][-1] == n
        assert np.array_equal(np.sort(host[ent]), np.arange(n))
        for v in range(s['nv']):
            seg = host[ent][host[ptr][v]:host[ptr][v + 1]]
            assert np.all(np.diff(seg) > 0)
    assert host['inc_ent'].dtype == np.int32
    if hub:
        assert np.diff(host['lnk_ptr']).max() > 4 * 32
    assert s['nv'] % (KERNEL_THREADS // group)
    Ke, tables = _port_operator_inputs(s)
    x = _t(s['x'])
    want = fem.elastic_operator_plain(x, Ke, tables, _t(s['weight']),
                                      _t(s['free']), 0.37, 1.3)
    got = _lane_operator(x, Ke, host, s['weight'], s['free'], 0.37, 1.3,
                         group)
    _close(got, want.numpy(), rtol=1e-12)


@pytest.mark.parametrize('group', [4, 32])
def test_one_sided_tables_give_the_plain_operator(rng, group):
    """The match rounds' tables (``fem.operator_tables`` of anchors: side 0
    weighs nothing and lists no entry, and padding anchors, weighed 0,
    none): the kernel's lanes through them equal the plain version of the
    same anchors as two-sided links."""
    s = _operator_system(rng, 2, 40)
    nv = s['nv']
    zero = np.zeros_like(s['bary1'])
    keep = np.arange(40) % 4 != 3
    weight = np.where(keep, s['weight'], 0.0)
    host = _numpy(fem.operator_tables(
        torch.as_tensor(s['tris']), nv, None, None, torch.as_tensor(s['idx1']),
        torch.as_tensor(s['bary1']), keep=torch.as_tensor(keep)))
    listed = host['lnk_ent'][:host['lnk_ptr'][-1]]
    assert host['lnk_ptr'][-1] == 3 * keep.sum()
    assert np.array_equal(np.sort(listed), 2 * np.nonzero(
        np.repeat(keep, 3))[0] + 1)
    Ke, _ = _port_operator_inputs(s)
    x = _t(s['x'])
    want = fem.elastic_operator_plain(
        x, Ke, {k: _t(v) if k.startswith('bary') else torch.as_tensor(v)
                for k, v in (('tris', s['tris']), ('idx0', s['idx1']),
                             ('bary0', zero), ('idx1', s['idx1']),
                             ('bary1', s['bary1']))},
        _t(weight), _t(s['free']), 0.37, 1.3)
    got = _lane_operator(x, Ke, host, weight, s['free'], 0.37, 1.3, group)
    _close(got, want.numpy(), rtol=1e-12)


def test_operator_tables_choose_one_group(rng):
    """``operator_tables`` picks the kernel's lanes a vertex G from the
    system's counts alone: the same system gives the same G in any dtype;
    about one CSR entry a lane, 4 to 32 lanes."""
    s = _operator_system(rng, 3, 30, True)
    a = _tables(s, dtype=F64)
    b = _tables(s, dtype=torch.float32)
    assert a['group'] == b['group'] == fem.operator_group(
        s['nv'], len(s['tris']), 30)
    assert a['group'] in fem.OPERATOR_GROUPS
    # the phase-7 window, a match pair of each round, the 2M-DOF pair
    assert fem.operator_group(1020, 1804, 9219) == 32
    assert fem.operator_group(518, 916, 2871) == 32
    assert fem.operator_group(510, 902, 459) == 16
    assert fem.operator_group(10 ** 6, 1994004, 10 ** 5) == 8
    assert fem.operator_group(100, 150, 20) == 8
    assert fem.operator_group(0, 0, 0) == 4
    assert fem.operator_group(5, 4, 0) == 4


@pytest.mark.parametrize('n_rows,n_vals,width', [
    (7, 40, 2), (50, 3, 1), (5, 0, 2), (1, 9, 3)])
def test_fixed_sum_is_index_add_in_ascending_order(rng, n_rows, n_vals,
                                                   width):
    """``fem.fixed_sum`` gives what ``index_add_`` sums, each row's entries
    added in ascending position (``np.add.at``'s order), rows no index
    reaches zero, with no values and with one row."""
    index = rng.integers(0, n_rows, n_vals)
    vals = rng.normal(size=(n_vals, width))
    want = np.zeros((n_rows, width))
    np.add.at(want, index, vals)
    fn = fem.fixed_sum(torch.as_tensor(index, dtype=torch.int32), n_rows)
    got = fn(_t(vals))
    assert got.shape == (n_rows, width)
    _close(got.numpy(), want, rtol=1e-12)
    assert torch.equal(fn(_t(vals)), got)
    ref = torch.zeros((n_rows, width), dtype=F64).index_add_(
        0, torch.as_tensor(index), _t(vals))
    _close(got.numpy(), ref.numpy(), rtol=1e-12)


@pytest.mark.cuda
def test_fixed_sum_keeps_its_bits_on_card(rng):
    """On the card ``fem.fixed_sum`` gives the same bits call after call
    (CUDA's ``index_add_`` does not), within f32 rounding of the sum."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    index = rng.integers(0, 1000, 200000)
    vals = rng.normal(size=(200000, 2))
    dev = torch.device('cuda')
    fn = fem.fixed_sum(torch.as_tensor(index, device=dev), 1000)
    v = torch.as_tensor(vals, dtype=torch.float32, device=dev)
    first = fn(v)
    assert all(torch.equal(first, fn(v)) for _ in range(5))
    want = np.zeros((1000, 2))
    np.add.at(want, index, vals)
    assert np.abs(first.cpu().numpy() - want).max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize('group', [4, 8, 16, 32])
@pytest.mark.parametrize('dtype,rtol', [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize('n_groups,n_links,untouched,hub', OPERATOR_CASES)
def test_kernel_matches_plain_on_card(rng, dtype, rtol, n_groups, n_links,
                                      untouched, hub, group):
    """The kernel at each G against the plain version on the card, within
    rtol of max|y| (f32 sums in another order), bit-equal to itself."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    s = _operator_system(rng, n_groups, n_links, untouched, hub)
    Ke, tables = _port_operator_inputs(s)
    dev = torch.device('cuda')
    tables = _tables(s, dev, dtype)
    tables['group'] = group
    args = (_t(s['x']).to(dev, dtype), Ke.to(dev, dtype).contiguous(), tables,
            _t(s['weight']).to(dev, dtype), _t(s['free']).to(dev, dtype),
            0.37, 1.3)
    device_mod.reset_launch_counts()
    op = fem.bind_elastic_operator(*args[1:])
    got, again = op(args[0]), op(args[0])
    torch.cuda.synchronize()
    assert device_mod.launch_counts()['fem_operator'] == 2
    want = fem.elastic_operator_plain(*args)
    assert torch.equal(got, again)
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), err
    if untouched:
        assert float(got[-1].abs().max()) == 0.0


# --------------------------- meshes and systems --------------------------- #

def _p(mesh):
    """The port's copy of a JAX mesh."""
    return state.mesh_from_init_dict(mesh.get_init_dict())


def _grid_pts(bbox, n=5, margin=2.0):
    xs = np.linspace(bbox[0] + margin, bbox[2] - margin, n)
    ys = np.linspace(bbox[1] + margin, bbox[3] - margin, n)
    xx, yy = np.meshgrid(xs, ys)
    return np.stack([xx.ravel(), yy.ravel()], -1)


def _material_table(kind):
    if kind == 'wrinkle':
        return MaterialTable.from_pickleable(
            os.path.join(REPO, 'configs', 'default_material_table.yaml'))
    mt = MaterialTable()
    if kind is not None:
        mt.add(kind, Material(type=kind.upper(), mask_label=10,
                              poisson_ratio=0.2))
    return mt


def _tile(bbox, uid, locked=False, mesh_size=25, kind=None, part=None):
    """A cartesian JAX mesh; ``kind`` ('svk', 'nhk', 'wrinkle') is the
    material of its triangles whose centroid x exceeds ``part`` (all of
    them when None)."""
    m = Mesh.from_bbox(bbox, cartesian=True, mesh_size=mesh_size, uid=uid,
                       locked=locked)
    if kind is None:
        return m
    mt = _material_table(kind)
    ids = np.zeros(m.num_triangles, np.int16)
    cx = m.vertices('INITIAL')[m.triangles].mean(axis=1)[:, 0] \
        + m.offset('INITIAL')[0, 0]
    ids[cx > (part if part is not None else -np.inf)] = mt[kind].uid
    return Mesh(m.vertices('INITIAL'), m.triangles, material_ids=ids,
                material_table=mt, uid=uid, locked=locked,
                initial_offset=m.offset('INITIAL'))


def _slms(meshes, links):
    """The same system in both packages: (JAX SLM, port SLM in f64)."""
    out = []
    for opt, ms in ((jopt, meshes), (popt, [_p(m) for m in meshes])):
        slm = opt.SLM(ms) if opt is jopt else opt.SLM(ms, dtype=F64,
                                                      device='cpu')
        for uid0, uid1, xy0, xy1, w in links:
            slm.add_link_from_coordinates(uid0, uid1, xy0, xy1, weight=w)
        out.append(slm)
    return out


def _assert_same_positions(jslm, pslm, tol, gear='MOVING'):
    for mj, mp in zip(jslm.meshes, pslm.meshes):
        d = np.abs(mp.vertices_w_offset(gear) - mj.vertices_w_offset(gear))
        assert float(d.max()) < tol, (mj.uid, float(d.max()))


def _pair_links(disp_scale=1.0):
    pts = _grid_pts((82, 5, 98, 95), n=5)
    disp = disp_scale * np.stack([1.5 * np.sin(pts[:, 1] / 25.0),
                                  np.full(len(pts), 2.0)], -1)
    return [(0, 1, pts, pts - disp, None)]


# ------------------------- the general linear path ------------------------- #

@pytest.fixture()
def general_calls(monkeypatch):
    """Counts the port's calls of the general path's operator."""
    calls = [0]
    bind = fem.bind_elastic_operator

    def spy(*a, **k):
        op = bind(*a, **k)

        def counted(x):
            calls[0] += 1
            return op(x)
        return counted
    monkeypatch.setattr(fem, 'bind_elastic_operator', spy)
    return calls


@pytest.mark.parametrize('case', ['positive_lambdas', 'eng_knots',
                                  'svk_step', 'nhk_free_three'])
def test_general_linear_solve_matches_jax(case, general_calls):
    """The general path: positive lambdas, an all-'wrinkle' mesh (ENG with
    the shipped curve), one SVK step, and three free meshes (rigid modes
    deflated, two-level preconditioner) with an NHK one."""
    kind = {'eng_knots': 'wrinkle', 'svk_step': 'svk',
            'nhk_free_three': 'nhk'}.get(case)
    free3 = case == 'nhk_free_three'
    meshes = [_tile((0, 0, 100, 100), 0, locked=not free3),
              _tile((80, 0, 180, 100), 1, kind=kind)]
    links = _pair_links()
    if free3:
        meshes.append(_tile((160, 0, 260, 100), 2))
        pts = _grid_pts((162, 5, 178, 95), n=4)
        links.append((1, 2, pts, pts + [1.0, -0.5], None))
    jslm, pslm = _slms(meshes, links)
    lam = (0.05, 1.0) if case == 'positive_lambdas' else (-0.05, -1.0)
    kw = dict(tol=1e-10, stiffness_lambda=lam[0], crosslink_lambda=lam[1])
    cj = jslm.optimize_linear(**kw)
    cp = pslm.optimize_linear(**kw)
    assert jslm._last_solve_fused is False and general_calls[0] > 0
    assert np.allclose(cp, cj, rtol=1e-8)
    assert cp[1] < cp[0]
    _assert_same_positions(jslm, pslm, LINEAR_PX)


def test_wrinkle_groups_carry_their_curve():
    """A mesh of the default material and the shipped 'wrinkle' (both
    ENG) splits into element groups by curve in the port, so the curve
    reaches the solve; the JAX package keeps one group and gives it the
    first triangle's material (no curve)."""
    m = _tile((80, 0, 180, 100), 1, kind='wrinkle', part=120)
    groups = _p(m).element_arrays()
    assert [g['knots'] is not None for g in groups] == [False, True]
    uid = m.material_table['wrinkle'].uid
    assert np.all(m.material_ids[groups[1]['start']:groups[1]['stop']] == uid)
    assert [g['knots'] is None for g in m.element_arrays()] == [True]


def _solver_multipliers(terms, groups, xp):
    """Each triangle's stiffness multiplier as the solver applies it: the
    ENG block's trace over the trace of the same element's block at
    multiplier 1 (blocks are linear in it). Triangle order."""
    out = []
    for (_, Ke, _), g in zip(terms, groups):
        B, area2 = g['B_area']
        ones = xp.ones_like(g['multiplier'])
        K1 = (fem if xp is torch else jfem).eng_element_stiffness(
            B, area2, ones, g['poisson'])
        tr = lambda K: np.asarray(K, np.float64).trace(axis1=1, axis2=2)
        out.append(tr(Ke) / tr(K1))
    return np.concatenate(out)


def test_element_terms_give_each_triangle_its_materials_curve():
    """A second witness to the element groups' split by curve: on a
    strained mesh of the default material and the shipped 'wrinkle', each
    triangle's multiplier in the solver's element terms is its material's
    base multiplier times that material's own curve at the triangle's
    area stretch, computed here per triangle with numpy (``np.interp`` on
    the areas). The port meets it within 1e-10; the JAX package applies
    no curve to any triangle (its one run takes the first triangle's
    material's curve: none), a fault of the reference."""
    m = _tile((80, 0, 180, 100), 1, kind='wrinkle', part=120)
    rng = np.random.default_rng(7)
    fixed = m.vertices_w_offset('FIXED')
    moving = fixed + rng.normal(0.0, 3.0, fixed.shape)
    m.set_vertices(moving - m.offset('FIXED'), 'MOVING',
                   offset=m.offset('FIXED'))
    tri = m.triangles

    def area(p):
        a, b, c = p[tri[:, 0]], p[tri[:, 1]], p[tri[:, 2]]
        return ((b - a)[:, 0] * (c - a)[:, 1] - (b - a)[:, 1] * (c - a)[:, 0])
    J = area(moving) / area(fixed)
    base = np.concatenate([g['multiplier'] for g in m.element_arrays()])
    uid2mat = m.material_table.uid_to_material()
    curve = np.ones(m.num_triangles)
    for uid in np.unique(m.material_ids):
        knots = uid2mat[int(uid)].stiffness_curve_knots()
        if knots is not None:
            sel = m.material_ids == uid
            curve[sel] = np.interp(J[sel], *knots)
    want = base * curve
    Jw = J[m.material_ids == m.material_table['wrinkle'].uid]
    assert 0 < Jw.min() < 0.75 and Jw.max() > 1.01   # beyond both ends
    assert not np.allclose(want, base, rtol=0.05)
    u = moving - fixed
    pslm = popt.SLM([_p(m)], dtype=F64, device='cpu')
    groups = pslm._build_system()['groups']
    terms = pslm._element_terms(groups, _t(u))
    got = _solver_multipliers(terms, groups, torch)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    jgroups = jopt.SLM([m])._build_system()['groups']
    jterms = jopt.SLM._element_terms(jgroups, jnp.asarray(u))
    jgot = _solver_multipliers(jterms, jgroups, jnp)
    assert np.allclose(jgot, base, rtol=1e-5)


def test_strained_linkless_mesh_relaxes_as_jax_does():
    """One free mesh strained by 10% with no link relaxes to its rest
    shape (up to a rigid motion), in both packages alike."""
    m = Mesh.from_bbox((0, 0, 100, 100), mesh_size=30, uid=0)
    v = m.vertices('INITIAL')
    m.set_vertices(v * [1.1, 1.0], 'MOVING', offset=m.offset('INITIAL'))
    jslm, pslm = _slms([m], [])
    kw = dict(tol=1e-10, stiffness_lambda=-1.0, crosslink_lambda=-1.0)
    assert pslm.optimize_linear(**kw) == jslm.optimize_linear(**kw)
    _assert_same_positions(jslm, pslm, LINEAR_PX)
    mp = pslm.meshes[0]

    def dists(gear):
        q = mp.vertices_w_offset(gear)
        return np.linalg.norm(q[:, None] - q[None], axis=-1)
    assert np.abs(dists('MOVING') - dists('INITIAL')).max() < 1e-6


def test_grouped_elastic_shares_deformation():
    m0 = _tile((0, 0, 100, 100), 0, locked=True, mesh_size=20)
    m1 = _tile((80, 0, 180, 100), 1, mesh_size=20)
    m2 = _tile((80, 0, 180, 100), 2, mesh_size=20)
    pts = _grid_pts((80, 0, 100, 100), n=5)
    disp = np.stack([1.5 * np.sin(pts[:, 1] / 25.0),
                     0.5 + 0.02 * pts[:, 1]], -1)
    jslm, pslm = _slms([m0, m1, m2], [(0, 1, pts, pts - disp, None)])
    kw = dict(tol=1e-10, stiffness_lambda=-0.01, crosslink_lambda=-1,
              groupings=np.array([0, 1, 1]))
    cj = jslm.optimize_linear(**kw)
    cp = pslm.optimize_linear(**kw)
    assert np.allclose(cp, cj, rtol=1e-8) and cp[1] < cp[0]
    _assert_same_positions(jslm, pslm, LINEAR_PX)
    p0, p1, p2 = pslm.meshes
    u1 = p1.vertices_w_offset('MOVING') - p1.vertices_w_offset('FIXED')
    u2 = p2.vertices_w_offset('MOVING') - p2.vertices_w_offset('FIXED')
    assert np.abs(u1).max() > 0.3
    assert np.allclose(u1, u2, atol=1e-9)
    assert np.allclose(p0.vertices_w_offset('MOVING'),
                       p0.vertices_w_offset('FIXED'))


def test_grouped_lock_discipline():
    m0 = _tile((0, 0, 100, 100), 0, locked=True, mesh_size=20)
    m1 = _tile((0, 0, 100, 100), 1, mesh_size=20)
    m2 = _tile((80, 0, 180, 100), 2, mesh_size=20)
    pts = _grid_pts((80, 0, 100, 100), n=5)
    jslm, pslm = _slms([m0, m1, m2], [(1, 2, pts, pts - [3.0, 0.0], None)])
    kw = dict(tol=1e-10, stiffness_lambda=-0.01, crosslink_lambda=-1,
              groupings=np.array([0, 0, 1]))
    jslm.optimize_linear(**kw)
    pslm.optimize_linear(**kw)
    _assert_same_positions(jslm, pslm, LINEAR_PX)
    p1, p2 = pslm.meshes[1], pslm.meshes[2]
    assert np.allclose(p1.vertices_w_offset('MOVING'),
                       p1.vertices_w_offset('FIXED'))
    u2 = p2.vertices_w_offset('MOVING') - p2.vertices_w_offset('FIXED')
    assert np.abs(u2).max() > 1.0
    dof_map, ndof, locked = pslm._grouping_dof_map([0, 0, 1])
    want = jslm._grouping_dof_map([0, 0, 1])
    assert np.array_equal(dof_map, want[0]) and ndof == want[1]
    assert np.array_equal(locked, want[2])


def test_grouping_rejects_topology_mismatch():
    slm = popt.SLM([_p(_tile((0, 0, 100, 100), 0, mesh_size=40)),
                    _p(_tile((0, 0, 100, 100), 1, mesh_size=20))],
                   dtype=F64, device='cpu')
    with pytest.raises(ValueError, match='share topology'):
        slm._grouping_dof_map([0, 0])


def test_balance_lambdas_match_jax():
    meshes = [_tile((0, 0, 100, 100), 0, locked=True),
              _tile((80, 0, 180, 100), 1, kind='svk')]
    jslm, pslm = _slms(meshes, _pair_links())
    u = pslm._gather_positions('MOVING') - pslm._gather_positions('FIXED')
    lams = ((-0.05, -1.0), (0.3, 2.0), (-0.4, 2.0))
    out = []
    for slm, u_dev in ((jslm, jnp.asarray(u)), (pslm, pslm._tensor(u))):
        sys_d = slm._build_system()
        terms = slm._element_terms(sys_d['groups'], u_dev)
        out.append([slm._balance_lambdas(sys_d, terms, *lam) for lam in lams])
    assert np.allclose(out[1], out[0], rtol=1e-12)
    assert out[1][1] == (0.3, 2.0)


# ----------------------------- Newton-Raphson ----------------------------- #

@pytest.mark.parametrize('kind', ['svk', 'nhk', 'wrinkle'])
def test_newton_raphson_nonlinear_material(kind):
    meshes = [_tile((0, 0, 100, 100), 0, locked=True, kind=kind),
              _tile((80, 0, 180, 100), 1, kind=kind)]
    jslm, pslm = _slms(meshes, _pair_links())
    assert not pslm.is_linear
    r0 = pslm.match_residues(gear='MOVING').max()
    kw = dict(stiffness_lambda=-0.05, crosslink_lambda=-1, tol=1e-10,
              max_newtonstep=4)
    cj = jslm.optimize_elastic(**kw)
    cp = pslm.optimize_elastic(**kw)
    assert np.allclose(cp, cj, rtol=1e-6)
    _assert_same_positions(jslm, pslm, NEWTON_PX)
    r1 = pslm.match_residues(gear='MOVING').max()
    assert r0 > 1.5 and r1 < 0.4 * r0, (r0, r1)
    assert pslm._count_flips('MOVING') == jslm._count_flips('MOVING') == 0


@pytest.mark.parametrize('residue_mode', ['huber', None])
def test_newton_flip_guard(residue_mode):
    """A far outlier pull: the flip guard rolls back and re-steps with a
    shrunk crosslink term, in both packages alike."""
    meshes = [_tile((0, 0, 100, 100), 0, locked=True, mesh_size=20),
              _tile((80, 0, 180, 100), 1, mesh_size=20, kind='svk')]
    pts = _grid_pts((80, 0, 100, 100), n=5)
    tgt = pts - [1.0, 0.5]
    tgt[0] = pts[0] + [70.0, 60.0]
    jslm, pslm = _slms(meshes, [(0, 1, pts, tgt, None)])
    # the later steps' tangents are indefinite and their CG runs out its
    # budget, so the budget is cut from 10000 to keep the test short
    kw = dict(tol=1e-8, stiffness_lambda=-0.5, crosslink_lambda=-1,
              max_newtonstep=4, residue_mode=residue_mode, residue_len=2,
              maxiter=1000)
    cj = jslm.optimize_Newton_Raphson(**kw)
    cp = pslm.optimize_Newton_Raphson(**kw)
    assert np.allclose(cp, cj, rtol=1e-6)
    _assert_same_positions(jslm, pslm, NEWTON_PX)
    assert pslm._count_flips('MOVING') == jslm._count_flips('MOVING')
    if residue_mode is not None:
        assert pslm._count_flips('MOVING') == 0


@pytest.mark.parametrize('mode', ['GLOBAL_RIGID', 'CONNECTED_AFFINE'])
def test_newton_anneal_and_outlier_relax(mode):
    meshes = [_tile((0, 0, 100, 100), 0, locked=True),
              _tile((80, 0, 180, 100), 1, kind='nhk')]
    jslm, pslm = _slms(meshes, _pair_links(2.0))
    kw = dict(stiffness_lambda=-0.05, crosslink_lambda=-1, tol=1e-10,
              max_newtonstep=2, anneal_mode=getattr(jconst, 'ANNEAL_' + mode),
              deform_outlier_constant=1.5)
    cj = jslm.optimize_Newton_Raphson(**kw)
    cp = pslm.optimize_Newton_Raphson(**kw)
    assert np.allclose(cp, cj, rtol=1e-6)
    for gear in ('MOVING', 'FIXED'):
        _assert_same_positions(jslm, pslm, NEWTON_PX, gear=gear)


# ------------------------------ coarse SLM ------------------------------ #

@pytest.mark.parametrize('reduction', [0.0, 0.5])
def test_coarse_mesh_slm_matches_jax(reduction):
    m0 = Mesh.from_bbox((0, 0, 100, 100), cartesian=True, mesh_size=10,
                        uid=0, locked=True)
    m1 = Mesh.from_bbox((80, 0, 180, 100), cartesian=True, mesh_size=10,
                        uid=1)
    pts = np.stack(np.meshgrid(np.linspace(82, 98, 3),
                               np.linspace(5, 95, 5)), -1).reshape(-1, 2)
    jslm, pslm = _slms([m0, m1], [(0, 1, pts, pts - [5.0, -7.0], None)])
    r0 = pslm.match_residues(gear='MOVING').max()
    rj = jopt.coarse_mesh_SLM(jslm, mesh_reduction_factor=reduction)
    rp = popt.coarse_mesh_SLM(pslm, mesh_reduction_factor=reduction)
    assert abs(rp - rj) < NEWTON_PX
    _assert_same_positions(jslm, pslm, NEWTON_PX)
    if reduction == 0.0:
        assert r0 > 5 and rp < 0.5, (r0, rp)


# --------------------------------- anneal --------------------------------- #

@pytest.mark.parametrize('mode', ['GLOBAL_RIGID', 'GLOBAL_AFFINE',
                                  'CONNECTED_RIGID', 'CONNECTED_AFFINE',
                                  'COPY_EXACT'])
def test_anneal_matches_jax(mode, rng):
    """Each anneal mode on a two-component mesh whose MOVING gear is a
    different affine of each component plus noise."""
    a = Mesh.from_bbox((0, 0, 60, 60), cartesian=True, mesh_size=20)
    b = Mesh.from_bbox((100, 0, 160, 60), cartesian=True, mesh_size=20)
    va, vb = a.vertices_w_offset('INITIAL'), b.vertices_w_offset('INITIAL')
    verts = np.concatenate([va, vb])
    tris = np.concatenate([a.triangles, b.triangles + len(va)])
    m = Mesh(verts, tris, uid=3)
    mv = verts.copy()
    mv[:len(va)] = mv[:len(va)] @ [[1.02, 0.03], [-0.04, 0.99]] + [3.0, -1.0]
    mv[len(va):] = mv[len(va):] @ [[0.98, -0.05], [0.05, 1.01]] + [-2.0, 4.0]
    mv += rng.normal(0, 0.3, mv.shape)
    m.set_vertices(mv, 'MOVING')
    mp = _p(m)
    code = getattr(jconst, 'ANNEAL_' + mode)
    for mesh in (m, mp):
        mesh.anneal(gear=('MOVING', 'FIXED'), mode=code)
    for gear in ('FIXED', 'MOVING'):
        assert np.abs(mp.vertices_w_offset(gear)
                      - m.vertices_w_offset(gear)).max() < 1e-9
    if mode == 'COPY_EXACT':
        assert np.allclose(mp.vertices_w_offset('FIXED'), mv)


# --------------------------- Link and SLM methods --------------------------- #

def test_link_methods_match_jax(rng):
    out = {}
    for opt in (jopt, popt):
        m0 = Mesh.from_bbox((0, 0, 200, 200), cartesian=True, mesh_size=50,
                            uid=0)
        m1 = Mesh.from_bbox((0, 0, 200, 200), cartesian=True, mesh_size=50,
                            uid=1)
        if opt is popt:
            m0, m1 = _p(m0), _p(m1)
        pts = _grid_pts((0, 0, 200, 200), n=8, margin=10.0)
        off = np.stack([6 * np.sin(pts[:, 1] / 60),
                        5 * np.cos(pts[:, 0] / 70)], -1)
        noise = np.random.default_rng(1).normal(0, 5.0, pts.shape)
        smooth = opt.Link.from_coordinates(m0, m1, pts, pts + off,
                                           gear=('INITIAL', 'INITIAL'))
        noisy = opt.Link.from_coordinates(m0, m1, pts, pts + noise,
                                          gear=('INITIAL', 'INITIAL'))
        for m in (m0, m1):
            m.set_vertices(m.vertices('INITIAL'), 'MOVING',
                           offset=m.offset('INITIAL'))
        res = [smooth.spatial_autocorrelation(),
               noisy.spatial_autocorrelation(),
               smooth.spatial_autocorrelation(sigma=1e-3)]
        smooth.adjust_weight_from_residue(residue_len=3,
                                          residue_mode='huber')
        res.append(smooth.weight().sum())
        smooth.reset_residue_weight()
        res.append(smooth.weight().sum())
        smooth.disable()
        res.append(smooth.num_matches)
        smooth.enable()
        res += [smooth.num_matches, smooth.disabled]
        out[opt] = res
    assert np.allclose(out[popt], out[jopt], rtol=1e-12)
    assert out[popt][0] > 0.7 and out[popt][1] < 0.45
    assert out[popt][5] == 0 and out[popt][6] == 64


def test_slm_bookkeeping_matches_jax():
    out = {}
    for opt in (jopt, popt):
        ms = [Mesh.from_bbox((80 * k, 0, 80 * k + 100, 100), mesh_size=25,
                             uid=k) for k in range(3)]
        if opt is popt:
            ms = [_p(m) for m in ms]
        slm = opt.SLM(ms[:1])
        slm.add_mesh(ms[1])
        slm.add_mesh(ms[2])
        pts = _grid_pts((82, 5, 98, 95), n=3)
        few = opt.Link.from_coordinates(ms[0], ms[1], pts[:2], pts[:2])
        many = opt.Link.from_coordinates(ms[1], ms[2], pts + [80, 0],
                                         pts + [80, 0])
        slm.add_link(few)
        slm.add_link(many, check_duplicates=True)
        counts = [len(slm.meshes), len(slm.links)]
        slm.prune_links(min_matches=3)
        counts += [len(slm.links), slm.links[0].num_matches]
        slm.clear_equation_terms()
        counts.append(slm._system)
        out[opt] = counts
    assert out[popt] == out[jopt] == [3, 2, 1, 9, None]
