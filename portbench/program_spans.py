"""What the per-layer metrics read of the program's own spans
(`raytracer_tpu_torch/utils/profiling.py`, names `rtx.*`).

- `idle_split(profile)`: the traced window's device idle time, split
  instant by instant over what the host was doing: in `rtx.readback`
  (the innermost open `rtx.*` span is the readback), in any other
  `rtx.*` span ("program"), or in none ("caller": the benchmark's loop
  between units).  It reads the gaps and the host events of the
  `Profile` that portbench/tracing.py builds.
- `span_seconds(run, name, key)`: one of the program's per-name span
  aggregates (host seconds on `time.perf_counter`, kept with tracing on
  or off), read through the program the run imported.

Both give None where there is nothing to read: a program without the
spans, a window without device work, a run off the card.
"""

from __future__ import annotations

import bisect

PREFIX = "rtx."
READBACK = "rtx.readback"


def innermost(spans):
    """[(start, end, name)] over every instant at which one of `spans`
    [(name, start, end)] is open, each piece under the innermost open
    span: the latest to start, and of those the first to end."""
    spans = [sp for sp in spans if sp[2] > sp[1]]
    events = []
    for i, (_, s, e) in enumerate(spans):
        events.append((s, 1, i))
        events.append((e, 0, i))
    events.sort()                   # at one instant, ends before starts
    active, pieces, prev = {}, [], None
    for t, starts, i in events:
        if active and t > prev:
            pieces.append((prev, t, max(active.values())[2]))
        if starts:
            name, s, e = spans[i]
            active[i] = (s, -e, name)
        else:
            del active[i]
        prev = t
    return pieces


def split_gaps(gaps, pieces):
    """Seconds of `gaps` [(start_us, seconds)] under the readback, under
    any other span, and under none, given `innermost` pieces."""
    starts = [p[0] for p in pieces]
    out = {"readback": 0.0, "program": 0.0, "caller": 0.0}
    for g0, length in gaps:
        g1 = g0 + length * 1e6
        covered = 0.0
        k = max(bisect.bisect_right(starts, g0) - 1, 0)
        while k < len(pieces) and pieces[k][0] < g1:
            s, e, name = pieces[k]
            part = min(e, g1) - max(s, g0)
            if part > 0:
                covered += part
                out["readback" if name == READBACK else "program"] += \
                    part * 1e-6
            k += 1
        out["caller"] += max(length - covered * 1e-6, 0.0)
    return out


def idle_split(profile):
    """{"readback", "program", "caller"}: seconds of device idle over the
    traced window, or None without device work or without `rtx.*` spans
    on the host.  Computed once per profile."""
    cached = getattr(profile, "_rtx_idle_split", None)
    if cached is not None:
        return cached or None
    spans = [h for h in profile._host if h[0].startswith(PREFIX)]
    out = {}
    if spans and profile.busy_s > 0:
        out = split_gaps(profile._gaps, innermost(spans))
    profile._rtx_idle_split = out
    return out or None


def span_seconds(run, name, key="total_s"):
    """The program's aggregate `key` ("total_s", "first_s") of the span
    `name` in a run on the card, or None: off the card (the harness's
    CPU tests read no set-up metric), for a program that keeps no span
    aggregates, or where the span never ran."""
    if getattr(getattr(run.session, "device", None), "type", None) != "cuda":
        return None
    profiling = getattr(getattr(run.port, "utils", None), "profiling", None)
    spans = getattr(profiling, "spans", None)
    if not callable(spans):
        return None
    value = spans().get(name, {}).get(key)
    return float(value) if value else None
