"""The port's spans and counters (utils/profiling.py) on the CPU: with no
profiler recording a span only adds to its per-name aggregate; under
torch.profiler the spans nest as the layers do; the set-up phases, the
row-block cache and the readbacks are counted; and no span changes a
render's result."""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.inline_scene import create_inline_raytracer
from raytracer_tpu_torch.utils import profiling


def _rt(width=16, height=16, **kw):
    return create_inline_raytracer(width=width, height=height, accel="brute",
                                   device="cpu", **kw)


def test_spans_without_a_profiler_only_aggregate(monkeypatch):
    """No record_function, CUDA event or synchronisation for any span;
    each span's calls and seconds grow."""
    rt = _rt()

    def refuse(*a, **k):
        raise AssertionError("a span reached the profiler or the device")
    for obj, name in ((torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function"),
                      (torch.cuda, "Event"), (torch.cuda, "synchronize")):
        monkeypatch.setattr(obj, name, refuse)
    names = ("rtx.render", "rtx.wavefront", "rtx.raygen", "rtx.level",
             "rtx.unsort", "rtx.film", "rtx.readback")
    before = {n: profiling.spans().get(n, {"calls": 0, "total_s": 0.0})
              for n in names}
    rt.render(1)
    after = profiling.spans()
    for n in names:
        assert after[n]["calls"] > before[n]["calls"], n
        assert after[n]["total_s"] > before[n]["total_s"], n
    assert after["rtx.level"]["calls"] - before["rtx.level"]["calls"] == 3


def _intervals(prof, name):
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == name]


def _inside(child, parents):
    return any(s <= child[0] and child[1] <= e for s, e in parents)


def test_spans_nest_on_the_profilers_clock():
    rt = _rt()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rt.render(1)
    render = _intervals(prof, "rtx.render")
    wavefront = _intervals(prof, "rtx.wavefront")
    level = _intervals(prof, "rtx.level")
    readback = _intervals(prof, "rtx.readback")
    assert len(render) == 1 and len(wavefront) == 1 and len(level) == 3
    assert len(readback) == 1
    assert all(_inside(w, render) for w in wavefront)
    assert all(_inside(lv, wavefront) for lv in level)
    assert _inside(readback[0], render)
    assert not _inside(readback[0], wavefront)


def test_setup_phases_are_timed():
    create_inline_raytracer(width=16, height=16, accel="bvh", device="cpu")
    s = profiling.spans()
    for name in ("rtx.setup.parse", "rtx.setup.scene", "rtx.setup.accel",
                 "rtx.setup.records"):
        assert s[name]["first_s"] > 0 and s[name]["calls"] >= 1, name


def test_row_block_builds_and_readback_bytes():
    rt = _rt(rows_per_frame=8)
    c0 = profiling.counters()
    for _ in range(4):              # cursor at rows 0, 8, 0, 8
        rt.trace_frame_additive()
    c1 = profiling.counters()
    assert c1["row_block_builds"] - c0["row_block_builds"] == 2
    rt.get_hdr()
    rt.get_hdr()
    c2 = profiling.counters()
    assert c2["readback_bytes"] - c1["readback_bytes"] == 2 * 16 * 16 * 3 * 4
    assert {"kernel_builds", "kernel_loads", "launches.bvh_spawn",
            "launches.bvh_shadow_shade", "launches.bvh_closest",
            "launches.cluster_closest"} <= set(c2)


def test_spans_change_no_result(monkeypatch):
    """The same render with spans, under a profiler, and with every span
    a bare pass-through: the same array, bit for bit."""
    from torch.profiler import ProfilerActivity, profile
    plain = _rt(8, 8).render(2)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _rt(8, 8).render(2)
    monkeypatch.setattr(profiling.span, "__enter__", lambda self: self)
    monkeypatch.setattr(profiling.span, "__exit__", lambda self, *e: False)
    bare = _rt(8, 8).render(2)
    assert plain.tobytes() == traced.tobytes() == bare.tobytes()
    assert np.isfinite(plain).all() and plain.sum() > 0


def test_span_aggregate_keeps_the_first_call():
    name = "rtx.test.first"
    for _ in range(3):
        with profiling.span(name, name="lib", rays=4):
            pass
    s = profiling.spans()[name]
    assert s["calls"] == 3 and s["first_s"] <= s["total_s"]
    with pytest.raises(ValueError):
        with profiling.span(name):
            raise ValueError("spans pass exceptions on")
    assert profiling.spans()[name]["calls"] == 4
