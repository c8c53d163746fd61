"""The device's side of a traced run, from ``torch.profiler``.

:class:`Profiled` runs a sub-window of calls under the profiler (CPU and
CUDA activity), writes its Chrome trace into the benchmark's own output
directory, reads it back and deletes it.  What it keeps:

* ``ops``: every operation on the device (kernels, copies, fills) as
  (name, category, start, end) in microseconds, with the host time of the
  runtime or driver call that launched it, matched by correlation id;
* ``spans``: the ``encbench:`` spans the host was in (:mod:`.spans`);
* ``window``: the host span of the profiled calls.

The functions below reduce these to the numbers the metric readers use.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

from .spans import PREFIX

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "encbench.subwindow"


def union(intervals):
    """Sorted disjoint [start, end] intervals covering ``intervals``."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def covered(intervals, t0, t1) -> float:
    """Length of [t0, t1] that the intervals cover."""
    return sum(max(0.0, min(t1, b) - max(t0, a))
               for a, b in union(intervals))


class DeviceTrace:
    def __init__(self, events):
        launches = {}
        ops, spans = [], []
        self.window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            t0 = float(e["ts"])
            t1 = t0 + float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                ops.append([name, cat, t0, t1, corr])
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = t0
            elif cat == "user_annotation" and name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], t0, t1))
            elif cat == "user_annotation" and name == WINDOW:
                self.window = (t0, t1)
        self.ops = [(n, c, a, b, launches.get(k)) for n, c, a, b, k in ops]
        self.spans = spans

    @classmethod
    def from_file(cls, path):
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def window_ops(self):
        t0, t1 = self.window
        return [op for op in self.ops if op[3] > t0 and op[2] < t1]

    def busy_us(self) -> float:
        t0, t1 = self.window
        return covered([(a, b) for _, _, a, b, _ in self.ops], t0, t1)

    def launched_in(self, names):
        """Device ops launched while the host was inside a span of
        ``names``, host-to-device and device-to-host copies left out."""
        inside = union([(a, b) for n, a, b in self.spans if n in names])
        out = []
        for op in self.ops:
            name, cat, _, _, launch = op
            if launch is None or (cat == "gpu_memcpy" and "DtoD" not in name):
                continue
            if any(a <= launch <= b for a, b in inside):
                out.append(op)
        return out

    def unattributed(self) -> int:
        """Device ops in the window whose launch the trace does not show."""
        return sum(op[4] is None for op in self.window_ops())

    def top_ops(self, n=10):
        total = defaultdict(float)
        for name, _, a, b, _ in self.window_ops():
            total[name] += (b - a) * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]

    def host_segments(self):
        """The window cut into (start, end, innermost span) pieces; the
        spans nest, as calls on one thread do."""
        t0, t1 = self.window
        edges = sorted([(a, 1, -a, name) for name, a, b in self.spans]
                       + [(b, 0, -a, name) for name, a, b in self.spans])
        stack, out, prev = [], [], t0
        for t, opening, _, name in edges:
            t = min(max(t, t0), t1)
            if t > prev:
                out.append((prev, t, stack[-1] if stack else "between spans"))
                prev = t
            if opening:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
        if t1 > prev:
            out.append((prev, t1, stack[-1] if stack else "between spans"))
        return out

    def idle_gaps(self, n=10):
        """Idle time on the device within the window, summed by the
        innermost span the host was in while the card waited."""
        t0, t1 = self.window
        busy = union([(max(a, t0), min(b, t1)) for _, _, a, b, _ in self.ops
                      if b > t0 and a < t1])
        gaps, prev = [], t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if t1 > prev:
            gaps.append((prev, t1))
        total = defaultdict(float)
        segs = self.host_segments()
        j = 0
        for a, b in gaps:
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < b:
                s, e, name = segs[k]
                total[name] += (min(b, e) - max(a, s)) * 1e-6
                k += 1
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]


def warm_profiler():
    """Start and stop the profiler once: its first start loads and sets up
    CUPTI, which takes seconds, so set-up pays for it and not the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass


class Profiled:
    """``with Profiled(path) as p: ...``, then ``p.read()`` once the timed
    window has closed: the trace of the calls made inside."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        self._window.__exit__(*exc)
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)

    def read(self) -> DeviceTrace:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        try:
            return DeviceTrace.from_file(self.path)
        finally:
            os.unlink(self.path)
