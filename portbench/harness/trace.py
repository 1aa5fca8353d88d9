"""The device trace of a traced slice of the window (torch.profiler's
CUDA activity: device operations and the host's CUDA runtime calls),
reduced to what the per-layer metrics read:
each device operation's name and interval, the union of the intervals
(busy time), the device operations that took most time, and the longest
idle gaps named by what the host was doing when they began."""

import bisect
import dataclasses


@dataclasses.dataclass
class Trace:
    """kernels: [(name, start_us, end_us)] of the device, in start order;
    host_ops: the same of the host's CUDA runtime calls; window_s: the
    slice's wall time on the host clock, from the profiler's start to
    the synchronize that ends the slice (its stop, which flushes the
    trace, left out); units: train steps or requests in the slice;
    calls: the mode's calls into the port in the slice (epochs or
    requests)."""

    kernels: list
    host_ops: list
    window_s: float
    units: int
    calls: int

    def busy_s(self):
        """Union of the device intervals (concurrent kernels counted
        once)."""
        return sum(b - a for a, b in _merged(self.kernels)) / 1e6

    def device_s(self, match):
        """Summed device time (s) of the operations whose name `match`
        accepts."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e6

    def top_ops(self, k=10):
        by = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return sorted(([n[:96], t] for n, t in by.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k=10):
        """The k longest gaps between merged device intervals, summed by
        the innermost host operation open at each gap's start."""
        merged = _merged(self.kernels)
        gaps = sorted(((b2 - a1, a1) for (_, a1), (b2, _) in
                       zip(merged, merged[1:]) if b2 > a1), reverse=True)
        starts = [s for _, s, _ in self.host_ops]
        by = {}
        for length, t in gaps[:k]:
            name = 'no host operation'
            best = None
            for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
                n, s, e = self.host_ops[i]
                if e >= t and (best is None or e - s < best):
                    best, name = e - s, n
                if t - s > 5e5:
                    break
            by[name] = by.get(name, 0.0) + length / 1e6
        return sorted(([n[:96], t] for n, t in by.items()),
                      key=lambda x: -x[1])[:k]


def _merged(kernels):
    out = []
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profiler(device):
    """A torch.profiler of the card's activity (not started): its device
    operations and the host's CUDA runtime calls. The host's PyTorch
    operations are left out; recording them slows the host enough to
    idle a card-paced step. On the CPU (tests) it records the host's
    operations, and the trace holds no device operation."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if device.type == 'cuda'
                               else ProfilerActivity.CPU])


def read(prof, window_s, units, calls):
    """The Trace of a stopped profiler."""
    from torch.autograd import DeviceType
    kernels, host = [], []
    for e in prof.events():
        item = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            kernels.append(item)
        else:
            host.append(item)
    kernels.sort(key=lambda k: k[1])
    host.sort(key=lambda k: k[1])
    return Trace(kernels, host, window_s, units, calls)
