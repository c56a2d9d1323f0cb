"""The readers of the program's spans on synthetic profiles: the device
idle split over the host's innermost `rtx.*` span, and the set-up
readers of the program's span aggregates.  Run with
`python -m pytest portbench/tests -q`."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench import run
from portbench.program_spans import idle_split, innermost
from portbench.tracing import Profile

IDLE = ("idle_readback_ms.render", "idle_program_ms.render",
        "idle_caller_ms.render")
SETUP = {"setup_parse_s.render": ("rtx.setup.parse", "total_s"),
         "setup_parse_s.inverse": ("rtx.setup.parse", "total_s"),
         "setup_accel_s.render": ("rtx.setup.accel", "total_s"),
         "setup_accel_s.inverse": ("rtx.setup.accel", "total_s"),
         "setup_kernel_s.render": ("rtx.kernel_load", "total_s"),
         "first_step_s.inverse": ("rtx.train_step", "first_s")}


def _event(name, dev, start, end):
    kind = torch.autograd.DeviceType.CUDA if dev else \
        torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=start, end=end))


def _profile(events, window_s=1e-3):
    return Profile(SimpleNamespace(events=lambda: events), window_s)


# a render of 1000 us: device work at 0-100, 200-300, 500-600 and
# 900-950; the host in rtx.render (10-800) > rtx.level (100-400) >
# rtx.bvh_spawn (150-250), then rtx.readback (600-780)
RENDER = [_event("portbench.render", False, 0, 1000),
          _event("rtx.render", False, 10, 800),
          _event("rtx.level", False, 100, 400),
          _event("rtx.bvh_spawn", False, 150, 250),
          _event("aten::sort", False, 260, 280),
          _event("rtx.readback", False, 600, 780),
          _event("spawn_kernel", True, 0, 100),
          _event("shadow_shade_kernel", True, 200, 300),
          _event("aten::copy_", True, 500, 600),
          _event("memcpy", True, 900, 950)]


def test_innermost_picks_the_latest_open_span():
    pieces = innermost([("a", 0, 10), ("b", 2, 6), ("c", 3, 4),
                        ("d", 6, 8), ("e", 5, 5)])
    assert pieces == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "b"),
                      (6, 8, "d"), (8, 10, "a")]
    # two spans from one instant: the one that ends first is inside
    assert innermost([("outer", 0, 9), ("inner", 0, 5)]) == \
        [(0, 5, "inner"), (5, 9, "outer")]


def test_the_split_covers_every_gap_once():
    prof = _profile(RENDER)
    split = idle_split(prof)
    # gaps: 100-200 (level 100-150, bvh_spawn 150-200: program),
    # 300-500 (level to 400, render to 500: program), 600-900
    # (readback 600-780, render 780-800: program, none 800-900: caller)
    assert split["readback"] == pytest.approx(180e-6)
    assert split["program"] == pytest.approx(100e-6 + 200e-6 + 20e-6)
    assert split["caller"] == pytest.approx(100e-6)
    total = sum(length for _, length in prof._gaps)
    assert sum(split.values()) == pytest.approx(total)
    assert 1e-3 - prof.busy_s == pytest.approx(total + 50e-6)
    r = run.Run(prof, 2, None, None, 0)
    got = {n: run._read_metric(n, r) for n in IDLE}
    assert got == pytest.approx({"idle_readback_ms.render": 0.09,
                                 "idle_program_ms.render": 0.16,
                                 "idle_caller_ms.render": 0.05})


def test_a_gap_under_no_program_span_goes_to_the_caller():
    events = [_event("rtx.render", False, 0, 100),
              _event("k", True, 0, 100), _event("k", True, 300, 400)]
    assert idle_split(_profile(events)) == {"readback": 0.0, "program": 0.0,
                                            "caller": pytest.approx(200e-6)}


def test_without_program_spans_or_device_work_nothing_is_read():
    older = [e for e in RENDER if not e.name.startswith("rtx.")]
    host_only = [e for e in RENDER if e.device_type ==
                 torch.autograd.DeviceType.CPU]
    for events in (older, host_only, []):
        r = run.Run(_profile(events), 1, None, None, 0)
        assert all(run._read_metric(n, r) is None for n in IDLE)


def _port(spans):
    profiling = SimpleNamespace(spans=lambda: spans)
    return SimpleNamespace(utils=SimpleNamespace(profiling=profiling))


def test_setup_readers_read_the_programs_aggregates():
    spans = {name: {"calls": 2, "total_s": 3.5, "first_s": 2.5}
             for name, _ in SETUP.values()}
    card = SimpleNamespace(device=torch.device("cuda"))
    r = run.Run(_profile([]), 1, card, _port(spans), 0)
    for metric, (_, key) in SETUP.items():
        assert run._read_metric(metric, r) == spans["rtx.setup.parse"][key]
    # an older program, a span never run, a run off the card
    cpu = SimpleNamespace(device=torch.device("cpu"))
    older = SimpleNamespace(utils=SimpleNamespace())
    for session, port in ((card, older), (card, _port({})),
                          (cpu, _port(spans)), (None, None)):
        r = run.Run(_profile([]), 1, session, port, 0)
        assert all(run._read_metric(m, r) is None for m in SETUP)


def test_every_new_metric_is_in_the_benchmark():
    names = {m["name"]: m for m in run.load_bench()["per_layer"]}
    for metric in IDLE:
        assert names[metric]["source"] == "device_trace"
        assert names[metric]["workloads"] == ["thai2_1024.render16"]
    for metric in SETUP:
        assert names[metric]["source"] == "host_clock"
        assert names[metric]["moves"] == "setup_s"
