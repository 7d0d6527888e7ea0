"""Reduction of a ``torch.profiler`` trace of the measured window.

The benchmark's own spans (``record_function`` labels that start with
:data:`PREFIX`) mark the window and each call into the program.  From
the device-side events inside the window this module takes the busy time
(the union of every kernel, copy and set's interval), the device time by
kernel name, the device time of the kernels each span launched, and the
idle gaps, each named by the innermost span the host had open then.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

PREFIX = "pcclbench::"
WINDOW = PREFIX + "window"

# The port's hand-written kernels by the names they launch under.
KERNELS = {
    "k1": re.compile(r"\bmatmul(_sm90)?_kernel\b"),
    "k2": re.compile(r"\b_rmsnorm_kernel\b"),
    "k3": re.compile(r"\bflash_(fwd|sm90)_kernel\b"),
    "k4": re.compile(r"\bssd_\w*_kernel\b"),
}


def kernel_of(name: str):
    """``k1``–``k4`` for a kernel of the port, else None."""
    return next((k for k, pat in KERNELS.items() if pat.search(name)), None)


@dataclass
class Summary:
    window_s: float = 0.0
    busy_s: float = 0.0
    device_s: Dict[str, float] = field(default_factory=dict)      # by op name
    span_device_s: Dict[str, float] = field(default_factory=dict)  # by span label
    span_count: Dict[str, int] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)    # (span, seconds)

    def kernel_s(self, kernel: str) -> float:
        """Device seconds of ``kernel`` (``k1``–``k4``) in the window."""
        return sum(s for name, s in self.device_s.items() if kernel_of(name) == kernel)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _kernels_us(event, label: str) -> float:
    """Device µs of the kernels ``event`` and its host-side children
    launched (a span's own device-side copy is no kernel)."""
    return (sum(k.duration for k in event.kernels if k.name != label)
            + sum(_kernels_us(c, label) for c in event.cpu_children))


def summarize(prof) -> Summary:
    """What the traced window shows (times in the profiler's µs → s)."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    spans, device = [], []
    for e in prof.events():
        if e.device_type == cpu and e.name.startswith(PREFIX):
            spans.append(e)
        elif e.device_type == cuda and not getattr(e, "is_user_annotation", False) \
                and not e.name.startswith(PREFIX):
            device.append((e.name, e.time_range.start, e.time_range.end))
    windows = [e for e in spans if e.name == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans, not one")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    out = Summary(window_s=(w1 - w0) / 1e6)

    inside, by_name = [], defaultdict(float)
    for name, a, b in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            inside.append((a, b))
            by_name[name] += (b - a) / 1e6
    busy = _merge(inside)
    out.busy_s = sum(b - a for a, b in busy) / 1e6
    out.device_s = dict(by_name)

    dev_s, count = defaultdict(float), defaultdict(int)
    for e in spans:
        if e.name != WINDOW:
            label = e.name[len(PREFIX):]
            dev_s[label] += _kernels_us(e, e.name) / 1e6
            count[label] += 1
    out.span_device_s, out.span_count = dict(dev_s), dict(count)

    # each idle gap named by the span open on the host at its middle (the
    # benchmark's spans follow one another; the latest to start is the one)
    opened = sorted(((e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
                     for e in spans if e.name != WINDOW))
    starts = [s for s, _, _ in opened]
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        mid = (a + b) / 2
        j = bisect.bisect_right(starts, mid) - 1
        name = opened[j][2] if j >= 0 and opened[j][1] >= mid else (
            "between spans" if opened else "window")
        out.gaps.append((name, (b - a) / 1e6))
    return out


def breakdown(s: Summary, top: int = 10) -> dict:
    """The optional ``breakdown`` of a traced result: the device ops that
    took most time, and idle time by what the host was doing."""
    ops = sorted(s.device_s.items(), key=lambda kv: -kv[1])[:top]
    idle = defaultdict(float)
    for name, sec in s.gaps:
        idle[name] += sec
    return {"device_ops": [[name[:120], sec] for name, sec in ops],
            "idle_gaps": [[name, sec] for name, sec in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}
