"""A kernel's share of its roofline over a traced window."""


def of(t, kernel):
    """100 x (sum of the calls' bounds) / (the device time of the work they
    launched); None where the window made no such call or the trace holds
    none of its work (the kernel is off the cell's path, or the card has
    no peaks)."""
    bound_s, calls, device_s = t.kernel_calls.get(kernel, (0.0, 0, 0.0))
    if calls == 0 or device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
