"""No solve of the port sums with atomics: a scan of the solver modules for
scatter-adds, the link transpose's one add pinned to unique indices, the
device-built operator tables held to numpy's CSR, and each of the
four solves that once summed with CUDA ``index_add_`` (the fused ENG solve,
the match schedule's per-round solve, the stacked window solve,
``relax_mesh``) run twice on equal inputs: equal bits. The solves run on
the CPU here and on the card in the ``cuda`` cases, which skip without one."""

import ast
import os

import numpy as np
import pytest
import torch

from feabas_tpu_torch import device as device_mod
from feabas_tpu_torch import optimizer
from feabas_tpu_torch.ops import fem
from feabas_tpu_torch.parallel import window

# the tier-1 run shares the cores among several pytest workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVER_FILES = ('feabas_tpu_torch/optimizer.py',
                'feabas_tpu_torch/ops/match_loop.py',
                'feabas_tpu_torch/parallel/window.py')
# tensor methods that add with atomics on a CUDA tensor
ATOMIC_METHODS = {'index_add_', 'index_add', 'scatter_add_', 'scatter_add',
                  'scatter_reduce_', 'scatter_reduce', 'index_reduce_',
                  'index_reduce', 'put_'}
# ops/fem's scatter-add primitives, kept for its CPU-only plain versions
SCATTER_PRIMITIVES = {'scatter_uv', '_link_scatter', 'crosslink_diag',
                      'stiffness_matvec', 'stiffness_diag', 'stiffness_force',
                      'crosslink_matvec', 'crosslink_rhs',
                      'elastic_operator_plain'}
# the one add allowed: the link transpose's, onto unique indices
ALLOWED = {('feabas_tpu_torch/parallel/window.py', '_StackOps.push',
            'index_add_')}


def _atomic_sums(path):
    """(path, enclosing function, callee) of every atomic sum in a file."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    found = []

    def visit(node, scope):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            scope = f'{scope}.{node.name}' if scope else node.name
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            accumulate = any(k.arg == 'accumulate' and not (
                isinstance(k.value, ast.Constant) and not k.value.value)
                for k in node.keywords) or len(node.args) > 2
            owner = node.func.value
            if (attr in ATOMIC_METHODS
                    or (attr in ('index_put_', 'index_put') and accumulate)
                    or (attr in SCATTER_PRIMITIVES
                        and isinstance(owner, ast.Name)
                        and owner.id == 'fem')):
                found.append((path, scope, attr))
        for child in ast.iter_child_nodes(node):
            visit(child, scope)

    visit(tree, '')
    return found


def test_no_solve_sums_with_atomics(tmp_path):
    """No scatter-add, accumulating index_put or call of ops/fem's
    scatter-add primitives in the solver modules, but the link transpose's
    unique-index add."""
    found = [f for p in SOLVER_FILES for f in _atomic_sums(p)]
    assert set(found) == ALLOWED, found
    # the scan sees what it looks for
    probe = tmp_path / 'probe.py'
    probe.write_text('x = torch.zeros(3).index_add_(0, i, v)\n'
                     'y = fem.stiffness_matvec(x, Ke, t)\n'
                     'z = a.index_put_((i,), v, accumulate=True)\n')
    assert [c for _, _, c in _atomic_sums(str(probe))] == [
        'index_add_', 'stiffness_matvec', 'index_put_']


def _smoke():
    """chip_smoke.py at the repo's root: it owns the seeded solve cases."""
    import sys
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize('ragged', [False, True])
def test_link_transpose_adds_onto_unique_vertices(ragged):
    """``build_link_transpose``'s targets: within a section no vertex twice,
    apart from slots that add only the zero row; so its one add lands one
    value on each zero."""
    system = _smoke().synthetic_stack(S=5, ragged=ragged)
    S, V = system['u'].shape[:2]
    tv, inc = window.build_link_transpose(system['links'], S, V)
    zero_row = 6 * system['links'][0].shape[1]
    for z in range(S):
        real = (inc[z] != zero_row).any(axis=1)
        assert real.any()
        assert len(set(tv[z][real])) == int(real.sum()), z
        assert not set(tv[z][real]) & set(tv[z][~real]), z


def _host_csr(vertex_of, nv):
    """Numpy CSR of the entries ``k`` whose vertex is ``vertex_of[k]``:
    (ptr (NV+1,), entries), each vertex's entries ascending."""
    vertex_of = np.asarray(vertex_of, np.int64).ravel()
    ptr = np.zeros(nv + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(vertex_of, minlength=nv))
    return ptr, np.argsort(vertex_of, kind='stable')


def test_anchor_tables_are_the_host_tables_without_side_0(rng):
    """``fem.operator_tables`` (built where the indices live) gives the
    numpy CSR tables of its links, entry for entry; for anchors (the match
    rounds' links, whose side 0 weighs nothing) those of the same anchors
    as two-sided links but for the entries of side 0 and of the links not
    kept, and G counts one side of the links kept."""
    nv, nt, nl = 300, 500, 120
    tris = rng.integers(0, nv, (nt, 3))
    idx = rng.integers(0, nv, (nl, 3))
    bary = rng.dirichlet(np.ones(3), nl)
    keep = rng.random(nl) < 0.7
    inc_ptr, inc_ent = _host_csr(tris, nv)
    ptr, ent = _host_csr(np.stack([idx, idx], -1), nv)
    t = [torch.as_tensor(a) for a in (tris, idx, bary)]
    two = fem.operator_tables(t[0], nv, t[1], torch.zeros_like(t[2]), t[1],
                              t[2])
    assert np.array_equal(two['lnk_ptr'].numpy(), ptr)
    assert np.array_equal(two['lnk_ent'].numpy(), ent)
    assert two['group'] == fem.operator_group(nv, nt, nl)
    got = fem.operator_tables(t[0], nv, None, None, t[1], t[2],
                              keep=torch.as_tensor(keep))
    for k, want in (('inc_ptr', inc_ptr), ('inc_ent', inc_ent),
                    ('tris', tris), ('idx0', idx), ('idx1', idx)):
        assert got[k].dtype == torch.int32
        assert np.array_equal(got[k].numpy(), want), k
    assert np.array_equal(got['bary1'].numpy(), bary)
    assert not got['bary0'].any()
    assert got['group'] == fem.operator_group(nv, nt, int(keep.sum()),
                                              sides=1)
    gp, ge = got['lnk_ptr'].numpy(), got['lnk_ent'].numpy()
    for v in range(nv):
        row = ent[ptr[v]:ptr[v + 1]]
        want = row[(row % 2 == 1) & keep[row // 6]]
        assert np.array_equal(ge[gp[v]:gp[v + 1]], want), v
    # a count the caller knows gives the same tables, read from no mask
    known = fem.operator_tables(t[0], nv, None, None, t[1], t[2],
                                keep=torch.as_tensor(keep),
                                n_kept=int(keep.sum()))
    assert all(torch.equal(known[k], got[k]) if torch.is_tensor(got[k])
               else known[k] == got[k] for k in got)


@pytest.mark.cuda
@pytest.mark.parametrize('group', [4, 8, 16, 32])
def test_one_sided_kernel_matches_plain_on_card(group):
    """The operator kernel through the match rounds' one-sided tables
    (``_solve_round``'s seeded round) at each G, within 1e-5 of max|y| of
    the plain version and bit-equal to itself."""
    dev = _device('cuda')
    args = _smoke().round_case(dev)
    rs, w = args[5], args[8]
    P, V = args[0].shape[:2]
    x = torch.randn((P * V, 2), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    rest = (w.reshape(-1).contiguous(),
            torch.ones((P * V, 1), device=dev), 1.0, 1.0)
    Ke = args[2].contiguous()
    op = fem.bind_elastic_operator(Ke, dict(rs['tables'], group=group),
                                   *rest)
    got, again = op(x), op(x)
    want = fem.elastic_operator_plain(x, Ke, rs['tables'], *rest)
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


# ------------------- the four solves, twice on equal inputs ------------------- #

DEVICES = ['cpu', pytest.param('cuda', marks=pytest.mark.cuda)]


def _device(name):
    if name == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    return torch.device(name)


def _equal_twice(fn):
    """fn() twice; both results (tensors or arrays, possibly in tuples)
    bit-equal."""
    a, b = fn(), fn()
    assert _smoke()._same_bits(a, b)
    return a


CASES = ['_linear_solve_eng', '_solve_round',
         'stack_solve, lattice + link transpose',
         'stack_solve, ragged, fixed-order sums', 'relax_mesh']


@pytest.mark.parametrize('dev', DEVICES)
@pytest.mark.parametrize('case', CASES)
def test_solve_keeps_its_bits(dev, case, monkeypatch):
    """Each repaired solve on ``chip_smoke.solve_cases``' seeded inputs,
    twice: equal, finite bits. The fused ENG case
    must take ``_linear_solve_eng``; on the card the per-round match solve
    launches the CG operator once an iteration."""
    dev = _device(dev)
    calls = []
    solve = optimizer._linear_solve_eng
    monkeypatch.setattr(optimizer, '_linear_solve_eng',
                        lambda *a, **k: calls.append(1) or solve(*a, **k))
    fn = _smoke().solve_cases(dev)[case]
    device_mod.reset_launch_counts()
    first = _equal_twice(fn)
    if case == '_linear_solve_eng':
        assert len(calls) == 2
    if case == '_solve_round' and dev.type == 'cuda':
        assert device_mod.launch_counts()['fem_operator'] > 2
    assert np.isfinite(np.concatenate([np.asarray(
        x.cpu() if torch.is_tensor(x) else x, np.float64).ravel()
        for x in (first if isinstance(first, tuple) else (first,))])).all()
