"""The traced run's reading of the profiler: device busy time, idle gaps by
what the host was doing, device operations by name, host spans, and the
device time of each wrapped kernel call.

Host spans and kernel calls are ``torch.profiler.record_function`` ranges
that the harness puts around the program's public functions
(``bench.span.<layer>``, ``bench.unit``, ``bench.kernel.<kernel>``), so
every timestamp read here comes from one clock, the profiler's. A device
operation belongs to a kernel call when the host event that launched it
(its linked correlation id) starts inside that call's range.
"""

import bisect
from collections import defaultdict

SPAN = 'bench.span.'
UNIT = 'bench.unit'
KERNEL = 'bench.kernel.'
WINDOW = 'bench.window'


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _segments(spans, t0, t1):
    """[t0, t1] cut into pieces, each labelled with the innermost span
    (start, end, label) over it, the latest started of those open ('harness'
    where none is)."""
    cuts = sorted({t0, t1} | {t for s, e, _ in spans for t in (s, e)
                              if t0 < t < t1})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        open_ = [(s, label) for s, e, label in spans if s <= mid <= e]
        out.append((a, b, max(open_)[1] if open_ else 'harness'))
    return out


def _idle_by_label(gaps, segments):
    """Seconds of the gaps (sorted, disjoint) under each segment's label."""
    idle = defaultdict(float)
    k = 0
    for gs, ge in gaps:
        while k < len(segments) and segments[k][1] <= gs:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < ge:
            a, b, label = segments[j]
            idle[label] += (min(b, ge) - max(a, gs)) / 1e9
            j += 1
    return idle


class Trace:
    """What one traced window gives the per-layer metric readers."""

    def __init__(self, window_s, busy_s, device_ops, span_s, kernel_calls,
                 breakdown, unattributed, attributed):
        self.window_s = window_s
        self.busy_s = busy_s
        self.device_ops = device_ops          # device operations launched
        self.span_s = span_s                  # {layer: seconds in its spans}
        # {kernel: (sum of the calls' bounds s, calls, device s)}
        self.kernel_calls = kernel_calls
        self.breakdown = breakdown
        self.unattributed = unattributed      # device ops with no host event
        self.attributed = attributed          # {'<kernel> by range|name': ops}
        self.mpx = 0.0                        # set by the harness
        self.units = 0


def digest(events, bounds, names):
    """``events``: the profiler's raw events, the window among them as the
    range ``bench.window``; ``bounds``: {kernel: [bound seconds of each
    call, in call order]}; ``names``: {kernel: compiled pattern of its
    device kernels' names}, which claims a device operation that no host
    event is linked to (a launch the tracer saw only on the device, as the
    port's ctypes launches are). Returns a ``Trace``."""
    t0_ns = t1_ns = None
    host_start = {}
    spans, units, kernel_ranges = [], [], defaultdict(list)
    dev = []
    for e in events:
        if 'CPU' in str(e.device_type()):
            name = e.name()
            # runtime API calls carry the tracer's own correlation ids
            if not name.startswith('cu'):
                host_start[e.correlation_id()] = e.start_ns()
            if name.startswith('bench.'):
                s = e.start_ns()
                iv = (s, s + e.duration_ns())
                if name.startswith(SPAN):
                    spans.append(iv + (name[len(SPAN):],))
                elif name == UNIT:
                    units.append(iv + ('unit',))
                elif name.startswith(KERNEL):
                    kernel_ranges[name[len(KERNEL):]].append(iv)
                elif name == WINDOW:
                    t0_ns, t1_ns = iv
        elif not e.name().startswith('bench.'):
            # (the ranges' own device-side copies are no device work)
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), e.name(),
                        e.linked_correlation_id()))
    if t0_ns is None:
        raise RuntimeError('the trace holds no bench.window range')
    dev = [d for d in dev if d[1] > t0_ns and d[0] < t1_ns]
    busy = _merged([(max(s, t0_ns), min(e, t1_ns)) for s, e, _, _ in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9

    by_name = defaultdict(float)
    for s, e, name, _ in dev:
        by_name[name[:200]] += (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    gaps, prev = [], t0_ns
    for s, e in busy + [[t1_ns, t1_ns]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle = _idle_by_label(gaps, _segments(spans + units, t0_ns, t1_ns))
    idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]

    span_s = defaultdict(float)
    for s, e, name in spans:
        span_s[name] += (e - s) / 1e9

    starts = {k: [s for s, _ in sorted(v)] for k, v in kernel_ranges.items()}
    ends = {k: [e for _, e in sorted(v)] for k, v in kernel_ranges.items()}
    device_s = defaultdict(float)
    how = defaultdict(int)
    unattributed = 0
    for s, e, name, linked in dev:
        h = host_start.get(linked)
        if h is None:
            unattributed += 1
        hit = None
        for k in starts:
            i = bisect.bisect_right(starts[k], h) - 1 if h is not None else -1
            if i >= 0 and h <= ends[k][i]:
                hit = k
                how[k + ' by range'] += 1
                break
        if hit is None and h is None:
            hit = next((k for k, pat in names.items() if pat.search(name)),
                       None)
            if hit is not None:
                how[hit + ' by name'] += 1
        if hit is not None:
            device_s[hit] += (e - s) / 1e9
    kernel_calls = {k: (sum(b), len(b), device_s.get(k, 0.0))
                    for k, b in bounds.items()}
    return Trace((t1_ns - t0_ns) / 1e9, busy_s, len(dev), dict(span_s),
                 kernel_calls,
                 {'device_ops': [[n, v] for n, v in ops],
                  'idle_gaps': [[n, v] for n, v in idle]}, unattributed,
                 dict(how))
