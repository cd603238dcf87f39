"""The profiler's view of a traced window: device time by kernel name,
busy and idle time, launches, and the idle gaps by what the host was doing.

The arithmetic follows ``chip_smoke.py``'s ``profile`` (phase 5: device
events only, summed by name, the idle share of the wall), read here from
the profiler's raw events so that a window of many thousand launches is
read in seconds; busy time is the union of the device intervals. The
harness marks the window and its own calls into the program with
``record_function`` spans named ``tcbench.*`` (:meth:`Tracer.span`), which
name the host's work over each idle gap.
"""
from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional, Tuple

WINDOW = "tcbench.window"
# device events that are copies or fills, not kernel launches
_NOT_LAUNCH = re.compile(r"^(Memcpy|Memset)")


class Tracer:
    """Spans and the profiler around the measured window when ``enabled``;
    otherwise every span is a no-op."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._mark = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._mark = self.span(WINDOW)
        self._mark.__enter__()

    def stop(self) -> Optional["Trace"]:
        """Close the window (after the device has finished its work) and
        read the trace; None when tracing is off."""
        if not self.enabled:
            return None
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        trace = Trace.from_events(self._prof.profiler.kineto_results.events())
        self._prof = self._mark = None
        return trace


class Trace:
    """Device events ``(name, start_ns, end_ns)`` inside the window, the
    host's events on the harness's thread, and the window itself."""

    def __init__(self, device: List[Tuple[str, int, int]],
                 host: List[Tuple[str, int, int]], window: Tuple[int, int]):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = sorted(host, key=lambda e: e[1])
        self.window = window

    @classmethod
    def from_events(cls, events) -> "Trace":
        from torch.autograd import DeviceType
        raw_device, host, window, thread = [], [], None, None
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                # the device-side copy of a host span is no device work
                if not e.name().startswith("tcbench."):
                    raw_device.append((e.name(), start, end))
            elif e.name() == WINDOW:
                window = (start, end)
                thread = _thread(e)
            else:
                host.append((e.name(), start, end, _thread(e)))
        if window is None:
            raise RuntimeError("the profiler's trace lacks the window mark")
        lo, hi = window
        device = [(n, max(a, lo), min(b, hi)) for n, a, b in raw_device
                  if b > lo and a < hi]
        host = [(n, a, b) for n, a, b, t in host
                if (thread is None or t == thread) and b > lo and a < hi]
        return cls(device, host, window)

    # -- sums --------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self._merged()) / 1e9

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        """Device seconds and event count per name."""
        out: Dict[str, List] = {}
        for name, a, b in self.device:
            s = out.setdefault(name, [0.0, 0])
            s[0] += (b - a) / 1e9
            s[1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}

    def matching(self, pattern: re.Pattern) -> Tuple[float, int]:
        """Device seconds and events of the names that ``pattern``
        finds."""
        secs, count = 0.0, 0
        for name, (s, c) in self.by_name().items():
            if pattern.search(name):
                secs += s
                count += c
        return secs, count

    def launches(self) -> int:
        """Kernel launches on the device (copies and fills left out)."""
        return sum(1 for name, _, _ in self.device
                   if not _NOT_LAUNCH.match(name))

    # -- idle gaps ---------------------------------------------------------
    def _merged(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, a, b in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def gaps(self) -> List[Tuple[int, int]]:
        """The window's idle intervals, in order."""
        out, t = [], self.window[0]
        for a, b in self._merged():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def gap_labels(self) -> Dict[str, float]:
        """Idle seconds by what the harness's thread was inside at each
        gap's midpoint: the innermost ``tcbench.*`` span, then the
        innermost host event within it."""
        gaps = sorted(((a + b) // 2, b - a) for a, b in self.gaps())
        out: Dict[str, float] = {}
        stack: List[Tuple[str, int, int]] = []
        i = 0
        for t, length in gaps:
            while i < len(self.host) and self.host[i][1] <= t:
                stack = [e for e in stack if e[2] >= self.host[i][1]]
                stack.append(self.host[i])
                i += 1
            stack = [e for e in stack if e[2] >= t]
            label = _label(stack)
            out[label] = out.get(label, 0.0) + length / 1e9
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(((n, s) for n, (s, _) in self.by_name().items()),
                     key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gap_labels().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _thread(e) -> Optional[int]:
    get = getattr(e, "start_thread_id", None)
    return get() if get is not None else None


def _label(stack: List[Tuple[str, int, int]]) -> str:
    if not stack:
        return "tcbench.window"
    spans = [e for e in stack if e[0].startswith("tcbench.")]
    span = spans[-1][0] if spans else "tcbench.window"
    inner = stack[-1][0]
    return span if inner == span else f"{span} > {inner}"
