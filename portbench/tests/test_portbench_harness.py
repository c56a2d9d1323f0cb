"""The benchmark's harness on the CPU: BENCHMARK.json keeps to its
rules, every cell resolves its configuration, mix, limits and metrics by
name, each cell runs end to end at a tiny size and agrees with the plain
reference, the faults it can have make `correct` false, and the harness
refuses to run without a card.  Run with
`python -m pytest portbench/tests -q`."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import run
from portbench.faults import FAULTS, plant
from portbench.generator import KINDS, load_json, make_session
from portbench.tracing import Profile, _union

ROOT = run.ROOT
BENCH = run.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# tiny sizes of each cell for the CPU (the port's plain kernels)
TINY = {
    "thai2_1024.render16": {"config": {"width": 16, "height": 16},
                            "traffic": {"spp": 2, "pool": 2,
                                        "check": {"pixels": 96}}},
    "thai2_1024.progressive": {"config": {"width": 16, "height": 16},
                               "traffic": {"rows_per_frame": 4,
                                           "frames_per_pass": 5,
                                           "check": {"pixels": 48}}},
    "ico3_tex_1024.inverse": {"config": {"width": 16, "height": 16}},
}


# a mix built and checked, but not a cell of BENCHMARK.json yet (PERF.md)
STANDBY = {"thai2_1024.progressive": {"config": "thai2_1024",
                                      "traffic": "progressive"}}


def _cell(name):
    return next((w for w in BENCH["workloads"] if w["name"] == name),
                STANDBY.get(name))


def session_numbers(cell, seed, fault=None, control=False):
    """A tiny session of `cell` on the CPU as a run drives it (set-up, a
    short window, the check): (numbers compared, their limits)."""
    w = _cell(cell)
    cfg = run._merge(load_json(ROOT, "configs", f"{w['config']}.json"),
                     TINY[cell].get("config"))
    mix = run._merge(load_json(ROOT, "traffic", f"{w['traffic']}.json"),
                     TINY[cell].get("traffic"))
    port = run.import_port()
    session = make_session(port, cfg, mix, seed, torch.device("cpu"), ROOT)
    if fault:
        with plant(port, mix["kind"], fault):
            session.setup()
            run.window(session, 0.2, False)
    else:
        session.setup()
        run.window(session, 0.2, False)
    got = session.kept()
    session.release()
    want = session.reference(torch.float32)
    if control:
        got = session.reference(torch.bfloat16)
    return (session.compare(got, want),
            load_json(ROOT, "checks", f"{cell}.json"))


def test_benchmark_json_keeps_its_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    w = _cell(cell)
    cfg = load_json(ROOT, "configs", f"{w['config']}.json")
    mix = load_json(ROOT, "traffic", f"{w['traffic']}.json")
    limits = load_json(ROOT, "checks", f"{cell}.json")
    assert mix["kind"] in KINDS
    assert os.path.isfile(os.path.join(ROOT, cfg["scene"]))
    assert os.path.isfile(os.path.join(ROOT, cfg["reference"]))
    assert limits and all(v > 0 for v in limits.values())
    e2e = run._cell_metrics(BENCH, cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layers = run._cell_metrics(BENCH, cell, "per_layer")
    assert layers
    for m in layers:
        path = os.path.join(ROOT, "portbench", "metrics", f"{m['name']}.py")
        assert os.path.isfile(path), path


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    base = os.path.join(ROOT, "portbench", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: the port's name begins with the
    JAX package's, so no prefix test will do."""
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in run.FORBIDDEN, (path, mod)
    for name in ("raytracer_tpu_torch", "jaxlib", "raytracer_tpu.x"):
        assert (name.split(".")[0] in run.FORBIDDEN) == \
            (name.split(".")[0] != "raytracer_tpu_torch")


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in run.FORBIDDEN + (run.PORT,), (path, mod)
            assert not mod.startswith("portbench") or \
                mod.startswith("portbench.reference"), (path, mod)
        assert "raytracer_tpu" not in open(path).read(), path


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_agrees_at_a_tiny_size(cell, trace):
    res = run.run_cell(cell, 2 ** 31 + 11, 0.5, bool(trace), device="cpu",
                       overrides=TINY[cell])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] >= 1
    assert res["failed"] == 0 and res["device"]["count"] == 1
    names = {m["name"] for m in run._cell_metrics(BENCH, cell, "end_to_end")}
    if trace:
        # no device here: every device reading finds nothing
        assert res["metrics"] == {} and res["device"]["busy_s"] == 0.0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == names
        assert all(m["value"] > 0 for m in res["metrics"].values())


def _kind(cell):
    return load_json(ROOT, "traffic", f"{_cell(cell)['traffic']}.json")["kind"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    port = run.import_port()
    with plant(port, _kind(cell), fault):
        res = run.run_cell(cell, 2 ** 31 + 12, 0.2, False, device="cpu",
                           overrides=TINY[cell])
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_standby_mix_agrees_and_its_faults_fail(fault):
    for cell in STANDBY:
        numbers, limits = session_numbers(cell, 2 ** 31 + 14, fault)
        failed = [k for k in limits if not numbers[k] <= limits[k]]
        assert bool(failed) == (fault is not None), (fault, numbers)


def test_without_a_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def _event(name, dev, start, end):
    kind = torch.autograd.DeviceType.CUDA if dev else \
        torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=start, end=end))


def test_profile_readers():
    events = [_event("portbench.render", False, 0, 1000),
              _event("aten::sort", False, 300, 500),
              _event("void spawn_kernel<1>(SpawnArgs)", True, 10, 110),
              _event("shadow_shade_kernel(ShadowArgs)", True, 100, 200),
              _event("closest_kernel(ClosestArgs)", True, 400, 450),
              _event("cluster_closest_kernel(ClosestArgs)", True, 450, 470),
              _event("void at::native::indexing_backward_kernel<float>", True,
                     600, 900)]
    prof = Profile(SimpleNamespace(events=lambda: events), 1e-3)
    assert prof.busy_s == pytest.approx(190e-6 + 70e-6 + 300e-6)
    assert prof.device_ops == 5
    assert _union([]) == (0.0, [])
    gaps = prof.breakdown()["idle_gaps"]
    assert gaps[0] == ["portbench.render", pytest.approx(200e-6)]
    assert gaps[1] == ["aten::sort", pytest.approx(130e-6)]
    r = run.Run(prof, 2, None, None, 0)
    names = [f[:-3] for f in os.listdir(os.path.join(ROOT, "portbench",
                                                     "metrics"))
             if f.endswith(".py") and not f.startswith("spawn_roofline")]
    read = {n: run._read_metric(n, r) for n in names}
    assert read["device_idle_pct.render"] == pytest.approx(44.0)
    assert read["fused_kernel_ms.render"] == pytest.approx(0.1)
    assert read["glue_ms.render"] == pytest.approx(0.185)
    assert read["closest_kernel_ms.inverse"] == pytest.approx(0.025)
    assert read["index_backward_ms.inverse"] == pytest.approx(0.15)
    assert read["launches_per_frame.progressive"] == pytest.approx(2.5)
    empty = run.Run(Profile(SimpleNamespace(events=lambda: []), 1.0), 1,
                    None, None, 0)
    assert all(run._read_metric(n, empty) is None for n in read)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_at_a_small_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    over = {"config": {"width": 64, "height": 64}}
    if cell.endswith("progressive"):
        over["traffic"] = {"rows_per_frame": 8, "frames_per_pass": 5}
    res = run.run_cell(cell, 2 ** 31 + 13, 0.5, True, overrides=over)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0 and res["metrics"]
