"""Named start/stop + scope timers with an aggregated, sorted report (a
copy of ``raytracer_tpu/utils/timing.py``, which the port may not
import).

Capability parity with the reference's standalone `timing` crate
(reference: timing/src/lib.rs:11-109): `start/stop` named sections,
RAII-style scopes (`time_scope` as a context manager instead of a Drop
guard), per-name mean/total aggregation, and a report sorted by total
time descending.  Each section also keeps its first interval's seconds,
and `add` takes an interval measured elsewhere (the program's spans,
utils/profiling.py, keep their aggregates here).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass(slots=True)
class _Section:
    total: float = 0.0
    count: int = 0
    started: float | None = None
    first: float | None = None


@dataclass
class BenchMark:
    sections: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def start(self, name: str):
        """timing/src/lib.rs:18-24"""
        self.sections.setdefault(name, _Section()).started = time.perf_counter()

    def stop(self, name: str):
        """timing/src/lib.rs:26-35"""
        sec = self.sections.get(name)
        if sec is None or sec.started is None:
            raise KeyError(f"timing section {name!r} was never started")
        elapsed = time.perf_counter() - sec.started
        sec.started = None
        self.add(name, elapsed)

    def add(self, name: str, seconds: float):
        """One interval of `seconds` under `name` (thread-safe)."""
        with self._lock:
            sec = self.sections.get(name)
            if sec is None:
                sec = self.sections[name] = _Section()
            if sec.first is None:
                sec.first = seconds
            sec.total += seconds
            sec.count += 1

    def snapshot(self) -> dict:
        """{name: {"calls", "total_s", "first_s"}} of every section
        (thread-safe)."""
        with self._lock:
            return {name: {"calls": s.count, "total_s": s.total,
                           "first_s": s.first}
                    for name, s in self.sections.items()}

    @contextmanager
    def time_scope(self, name: str):
        """timing/src/lib.rs:37-43 (+ Scope Drop at :89-93)"""
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def collect_timing_results(self):
        """timing/src/lib.rs:45-58 — (name, mean, total) sorted by total
        descending."""
        rows = [(name, s.total / s.count if s.count else 0.0, s.total)
                for name, s in self.sections.items()]
        return sorted(rows, key=lambda r: r[2], reverse=True)

    def report(self) -> str:
        """Display parity (timing/src/lib.rs:95-109)."""
        lines = [f"{name}: mean {mean * 1e3:.3f} ms  total {total * 1e3:.3f} ms  "
                 for name, mean, total in self.collect_timing_results()]
        return "\n".join(lines)
