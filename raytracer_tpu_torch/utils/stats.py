"""Per-frame fps / primary-rays-per-second meter with running means (a
copy of ``raytracer_tpu/utils/stats.py``, which the port may not import).

Capability parity with the reference stats module (reference:
raytracer_lib/src/stats.rs:3-40): `stats()` after each frame returns the
formatted per-frame line, `mean_stats()` the running means printed at
exit (raytracer/src/main.rs:213-216).
"""

from __future__ import annotations

import time


class Stats:
    def __init__(self):
        self.last_iteration = time.perf_counter()
        self.fps_sum = 0.0
        self.primrays_per_sec_sum = 0.0
        self.num_measurements = 0

    def stats(self, num_primary_rays: int) -> str:
        """stats.rs:21-31"""
        now = time.perf_counter()
        frame_duration = now - self.last_iteration
        self.last_iteration = now
        fps = 1.0 / frame_duration if frame_duration > 0 else float("inf")
        self.fps_sum += fps
        primrays_per_sec = num_primary_rays / frame_duration if frame_duration > 0 else 0.0
        self.primrays_per_sec_sum += primrays_per_sec
        self.num_measurements += 1
        return f"fps: {fps}  primary rays/s: {int(primrays_per_sec)}"

    def mean_stats(self) -> str:
        """stats.rs:33-39"""
        n = max(self.num_measurements, 1)
        return (f"mean fps: {self.fps_sum / n}  "
                f"mean primary rays/s: {self.primrays_per_sec_sum / n}")
