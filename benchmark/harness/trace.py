"""The traced slice of a run: torch.profiler over a fixed stretch of the
window, reduced to the device's busy time (the union of its intervals, as
``chip_smoke.py::phase_profile`` takes it), device time per kernel name,
and the breakdown the result line carries (the device operations that took
most time, the longest idle gaps by what the host was doing)."""
from __future__ import annotations

import bisect
import collections
import time

import torch

TOP = 10
NAME = 160  # characters of an operation's name kept in the breakdown


class Trace:
    """start() / stop() around the traced slice; summary() after stop()."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.wall_s = 0.0
        self._t0 = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        """Ends the traced slice; a no-op when it is not running."""
        if self.prof is None or self.wall_s:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        """{"busy_s", "window_s", "kernel_s": {name: s}, "breakdown"}; busy_s
        is 0 where the profiler saw no device activity."""
        dev_type = torch.autograd.DeviceType.CUDA
        device, host = [], []
        for e in self.prof.events():
            span = (e.time_range.start, e.time_range.end, e.name)
            if e.device_type != dev_type:
                host.append(span)
            elif not e.is_user_annotation:  # a host range mirrored on the device's timeline
                device.append(span)
        device.sort()
        kernel_us = collections.Counter()
        for start, end, name in device:
            kernel_us[name] += end - start
        busy_us, gaps = 0.0, []
        cur_start = cur_end = None
        for start, end, _ in device:  # union of device intervals
            if cur_end is None or start > cur_end:
                if cur_end is not None:
                    busy_us += cur_end - cur_start
                    gaps.append((cur_end, start))
                cur_start, cur_end = start, end
            else:
                cur_end = max(cur_end, end)
        if cur_end is not None:
            busy_us += cur_end - cur_start
        return {
            "busy_s": busy_us / 1e6,
            "window_s": self.wall_s,
            "kernel_s": {k: v / 1e6 for k, v in kernel_us.items()},
            "breakdown": {
                "device_ops": [[k[:NAME], v / 1e6] for k, v in kernel_us.most_common(TOP)],
                "idle_gaps": idle_gaps_by_host(gaps, host),
            },
        }


def idle_gaps_by_host(gaps, host) -> list:
    """The idle gaps' seconds summed by the innermost host operation running
    at each gap's middle, the TOP largest."""
    host = sorted(host)
    starts = [h[0] for h in host]

    by_name = collections.Counter()
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        name = "(no host operation)"
        # The latest-starting host span that covers the middle: the innermost.
        for j in range(i - 1, max(i - 4096, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by_name[name[:NAME]] += (b - a) / 1e6
    return [[k, v] for k, v in by_name.most_common(TOP)]


def device_seconds(kernel_s: dict, patterns) -> float:
    """Device seconds of the kernels whose names contain one of `patterns`."""
    return sum(s for name, s in kernel_s.items() if any(p in name for p in patterns))
