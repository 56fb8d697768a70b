"""Share of the subpixel refinement's calls that ran on the card (the
program's counters ``thumbnail.subpixel_on_device`` over
``thumbnail.subpixel_calls``, counted by ``thumbnail.py``'s
``refine_matches_subpixel`` as it chooses its route).

The harness reads the counters after the window without zeroing them
before it, so they cover every unit of the run, the set-up's untimed one
included. None where the program keeps no such counter or made no call."""


def read(t):
    try:
        from feabas_tpu_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    n = c.get('thumbnail.subpixel_calls', 0)
    return 100.0 * c.get('thumbnail.subpixel_on_device', 0) / n \
        if n > 0 else None
