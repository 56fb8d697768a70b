"""A function-scope profiler range around a wrapped kernel call.

A profiler links a kernel launched from C (with no operator of its own) to
the innermost function-scope range open around the launch; the harness's
``bench.kernel.<kernel>`` range is a user annotation, which takes no such
link. Where the program opens no range at its launch (as the thumbnail
kernels before their launches went through ``device.launch_on``), a
CLI's span around the whole pair would take it, and the call's device
work would fall outside its kernel range. A second range of the same name,
function-scope and inside the harness's, keeps it there."""


def ranged(kernel, fn):
    """``fn`` with each call inside the function-scope range
    ``bench.kernel.<kernel>``."""
    from torch._C._profiler import _RecordFunctionFast

    def call(*args, **kwargs):
        with _RecordFunctionFast('bench.kernel.' + kernel):
            return fn(*args, **kwargs)
    return call
