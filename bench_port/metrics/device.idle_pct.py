"""Share of the traced window in which no kernel, copy or set ran on the
card."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
