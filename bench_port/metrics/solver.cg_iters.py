"""CG loop trips a solve (the program's counters ``solver.cg_iters`` over
``solver.cg_calls``, counted by ``ops/fem.cg_solve`` as each solve ends:
the trips the host ran, a batch of systems' frozen ones included).

The harness reads the counters after the window without zeroing them
before it, so they cover every unit of the run, the set-up's untimed one
included. None where the program keeps no such counter or ran no solve."""


def read(t):
    try:
        from feabas_tpu_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    n = c.get('solver.cg_calls', 0)
    return c.get('solver.cg_iters', 0) / n if n > 0 else None
