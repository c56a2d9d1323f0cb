"""Readings of a traced window (torch.profiler with CPU and CUDA
activity): the device's busy time as the union of its operations'
intervals, device time by kernel name, the number of device operations,
and the breakdown the result line carries (the device operations that
took most time, and the longest idle gaps by the host operation that was
running when each began)."""

from __future__ import annotations

import re

import numpy as np
import torch

NAME_CHARS = 160        # a kernel's name in the breakdown, cut to this


class Profile:
    """What the metric readers read of one traced window."""

    def __init__(self, prof, window_s):
        self.window_s = window_s
        dev, host = [], []
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False):
                    continue        # a span's shadow on the device's line
                dev.append((e.name, start, end))
            elif e.device_type == torch.autograd.DeviceType.CPU:
                host.append((e.name, start, end))
        self.device_ops = len(dev)
        self.by_name = {}
        for name, start, end in dev:
            s, n = self.by_name.get(name, (0.0, 0))
            self.by_name[name] = (s + (end - start) * 1e-6, n + 1)
        self._host = host
        self.busy_s, self._gaps = _union(dev)

    def device_s(self, pattern):
        """Device seconds of the operations whose name matches the regular
        expression `pattern`."""
        rx = re.compile(pattern)
        return sum(s for name, (s, _) in self.by_name.items()
                   if rx.search(name))

    def breakdown(self):
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        ops = [[name[:NAME_CHARS], s] for name, (s, _) in top]
        gaps = []
        if self._host and self._gaps:
            names = [h[0] for h in self._host]
            hs = np.array([h[1] for h in self._host])
            he = np.array([h[2] for h in self._host])
            for start, length in sorted(self._gaps, key=lambda g: -g[1])[:10]:
                cover = np.nonzero((hs <= start) & (he >= start))[0]
                name = (names[cover[np.argmax(hs[cover])]] if cover.size
                        else "(no host operation)")
                gaps.append([name[:NAME_CHARS], length])
        return {"device_ops": ops, "idle_gaps": gaps}


def _union(intervals):
    """(busy seconds, [(gap start in us, gap seconds)]) of the union of
    (name, start_us, end_us) intervals."""
    if not intervals:
        return 0.0, []
    spans = sorted((s, e) for _, s, e in intervals)
    busy, gaps = 0.0, []
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, (s - cur_e) * 1e-6))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy * 1e-6, gaps
