"""The traced window: ``torch.profiler`` over it, reduced to what the
per-layer metrics and the result's ``breakdown`` read.

* ``busy_s``: the union of the device's operations (kernels, copies,
  fills) inside the window span, ``window_s`` that span's length.
* ``kernel_s``: device seconds by kernel name (namespace, template and
  arguments cut).
* ``breakdown``: the ten device operations that took most time, and the
  device's idle time by what the host was doing: the benchmark's span
  (``bench.fit``, ``bench.predict_call``, ``bench.cycle``) and the
  innermost host operation at the middle of each gap.
"""
from __future__ import annotations

import bisect
import contextlib
import types

import torch

WINDOW = "bench.window"
TOP = 10


def kernel_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].strip()


@contextlib.contextmanager
def window_profile(enabled: bool, device):
    """Profile the ``with`` body when ``enabled``; yields a holder whose
    ``prof`` is the finished profile (None when not enabled)."""
    holder = types.SimpleNamespace(prof=None)
    if not enabled:
        with torch.profiler.record_function(WINDOW):
            yield holder
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield holder
    holder.prof = prof


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _raw_events(prof):
    """(name, is_device, start_us, end_us) of every event, read from the
    profiler's raw results: building its ``FunctionEvent`` tree takes
    minutes for a window of fits."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        dev = e.device_type() == DeviceType.CUDA
        if dev and e.is_user_annotation():
            continue
        yield e.name(), dev, a, a + e.duration_ns() / 1e3


def reduce(prof) -> dict:
    """busy_s, window_s, kernel_s and the breakdown of a finished
    profile."""
    host, device, spans = [], [], []
    win = None
    for name, dev, a, b in _raw_events(prof):
        if dev:
            if not name.startswith("bench."):
                device.append((a, b, kernel_name(name)))
        elif name == WINDOW:
            win = (a, b)
        elif name.startswith("bench."):
            spans.append((a, b, name))
        else:
            host.append((a, b, name))
    if win is None:
        return {}
    w0, w1 = win
    device = [(max(a, w0), min(b, w1), n) for a, b, n in device
              if b > w0 and a < w1]
    kernel_s: dict[str, float] = {}
    for a, b, n in device:
        kernel_s[n] = kernel_s.get(n, 0.0) + (b - a) * 1e-6
    busy = _union([(a, b) for a, b, _ in device])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    # idle gaps inside the window, labelled by the host's activity
    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    spans.sort()
    h_starts = [a for a, _, _ in host]
    s_starts = [a for a, _, _ in spans]

    def inner(items, starts, t, look=64):
        i = bisect.bisect_right(starts, t)
        for a, b, n in reversed(items[max(0, i - look):i]):
            if b >= t:
                return n
        return None

    idle: dict[str, float] = {}
    for a, b in gaps:
        t = 0.5 * (a + b)
        label = (f"{inner(spans, s_starts, t) or 'bench.window'}:"
                 f"{inner(host, h_starts, t) or 'python'}")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
            "kernel_s": kernel_s,
            "breakdown": {"device_ops": top(kernel_s), "idle_gaps": top(idle)}}
