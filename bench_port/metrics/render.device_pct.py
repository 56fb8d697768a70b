"""Share of the mesh renderer's blocks rendered on the card (the program's
counters ``render.device_blocks`` over ``render.blocks``, counted by the
device engine, ``ops/render.DeviceRenderEngine``, and the host route,
``renderer._render_on_host``).

The harness reads the counters after the window without zeroing them
before it, so they cover every unit of the run, the set-up's untimed one
included. None where the program keeps no such counter or rendered
nothing."""


def read(t):
    try:
        from feabas_tpu_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    n = c.get('render.blocks', 0)
    return 100.0 * c.get('render.device_blocks', 0) / n if n > 0 else None
