"""The general CG operator (``ops/fem.bind_elastic_operator``'s matvec,
x -> free * (lam_s K x + lam_c C^T W^2 C x)), counted as ``chip_smoke.py``
``fem_bound`` / ``listed_links`` count it: the links that weigh and the
link sides that the tables list, each once; 26 FLOP an element corner
(two rows of 6 FMAs and their sums), 12 a side and 6 a link for the
weighted residual once, 4 a side's point, 8 a vertex. Float data in the
solve's dtype, indices int32. The kernel's own CSR tables are its design's
cost, not the function's, and are not counted."""

import torch

from roofline.common import bound

KERNEL = 'fem_operator'
# the device kernel's name in the trace (its ``__global__`` in csrc/)
NAME = r'\boperator_kernel\b'
MODULE, ATTR = 'feabas_tpu_torch.ops.fem', 'bind_elastic_operator'


def call_bound(pk, tables):
    nv, nt = int(tables['nv']), int(tables['nt'])
    ent = tables['lnk_ent'][:int(tables['lnk_ptr'][-1])].long()
    nl, sides = int(torch.unique(ent // 6).numel()), int(ent.numel()) // 3
    fb = tables['bary0'].element_size()
    floats = nt * 36 + 3 * sides + nl + nv + 2 * nv + 2 * nv
    ints = nt * 3 + 3 * sides
    flop = nt * 3 * 26 + sides * 12 + nl * 6 + 3 * sides * 4 + nv * 8
    dtype = 'float64' if tables['bary0'].dtype == torch.float64 else 'float32'
    return bound(pk, flop, fb * floats + 4 * ints, dtype)


def wrap(orig, record):
    """``bind_elastic_operator`` whose matvecs ``record`` one call each:
    ``record(KERNEL, bound, fn, *args)`` runs ``fn(*args)`` inside the
    kernel's range. The bound reads the tables' contents, so it is worked
    out after the window (``bound`` is a function): the traced window gains
    no host sync of its own."""
    def bind(Ke, tables, weight, free, lam_s, lam_c):
        matvec = orig(Ke, tables, weight, free, lam_s, lam_c)
        if tables['bary0'].device.type != 'cuda':
            return matvec
        kept = {k: tables[k] for k in ('nv', 'nt', 'bary0', 'lnk_ent',
                                       'lnk_ptr')}
        once = []

        def b():
            if not once:
                once.append(call_bound(record.peaks, kept))
            return once[0]

        def counted(x):
            return record(KERNEL, b, matvec, x)
        if hasattr(matvec, 'inputs'):
            counted.inputs = matvec.inputs
        return counted
    return bind
