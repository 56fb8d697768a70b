"""Device operations (kernels, copies, sets) the window launched, per Mpx
of its units."""


def read(t):
    return t.device_ops / t.mpx if t.mpx > 0 and t.device_ops > 0 else None
