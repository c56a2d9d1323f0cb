"""The benchmark's harness on the CPU: BENCHMARK.json keeps to its
rules, every cell resolves its configuration, mix, limits and metrics by
name, each cell runs end to end at a tiny size and agrees with the plain
reference, the faults it can have make `correct` false, and the harness
refuses to run without a card.  Run with
`python -m pytest portbench/tests -q`."""

from __future__ import annotations

import ast
import importlib
import json
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
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

# a mix built and checked, but not a cell of BENCHMARK.json yet (PERF.md)
STANDBY = {"thai2_1024.progressive": {"config": "thai2_1024",
                                      "traffic": "progressive"}}
CELLS_AND_STANDBY = CELLS + list(STANDBY)


def tiny(cell, where="cpu"):
    """The small sizes of `cell` for tests, `portbench/tiny/<cell>.json`:
    "cpu" (the port's plain kernels here) or "card" (a quick run on a
    CUDA card), as run_cell's `overrides`."""
    return load_json(ROOT, "tiny", f"{cell}.json")[where]


def _cell(name):
    return next((w for w in BENCH["workloads"] if w["name"] == name),
                STANDBY.get(name))


def session_numbers(cell, seed, fault=None, control=False):
    """A tiny session of `cell` on the CPU as a run drives it (set-up, a
    short window, the check): (numbers compared, their limits)."""
    w = _cell(cell)
    over = tiny(cell)
    cfg = run._merge(load_json(ROOT, "configs", f"{w['config']}.json"),
                     over.get("config"))
    mix = run._merge(load_json(ROOT, "traffic", f"{w['traffic']}.json"),
                     over.get("traffic"))
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
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
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
    assert os.path.isfile(os.path.join(ROOT, "portbench", "tiny",
                                       f"{cell}.json"))
    assert mix["kind"] in KINDS
    assert os.path.isfile(os.path.join(ROOT, cfg["scene"]))
    assert os.path.isfile(os.path.join(ROOT, cfg["reference"]))
    assert limits and all(v > 0 for v in limits.values())
    e2e = run._cell_metrics(BENCH, cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layers = run._cell_metrics(BENCH, cell, "per_layer")
    assert layers
    for m in layers:
        path = os.path.join(ROOT, "portbench", "metrics",
                            f"{run._source(m['name'])}.py")
        assert os.path.isfile(path), path


def test_every_alias_reads_a_metric_of_its_kind():
    """An alias is a metric of BENCHMARK.json that reports another's
    reading under its own name: of the same section, unit and sense, and
    in cells that the other does not list."""
    folder = os.path.join(ROOT, "portbench", "aliases")
    for f in sorted(os.listdir(folder)) if os.path.isdir(folder) else []:
        name = f[:-len(".json")]
        source = run._source(name)
        for key in ("end_to_end", "per_layer"):
            named = {m["name"]: m for m in BENCH[key]}
            if name in named:
                mine, theirs = named[name], named[source]
                break
        else:
            raise AssertionError(f"alias {name} is no metric of the benchmark")
        assert source != name and run._source(source) == source
        for k in ("unit", "better", "source"):
            assert mine[k] == theirs[k], (name, k)
        assert not set(mine.get("workloads", CELLS)) & set(
            theirs.get("workloads", CELLS)), name


@pytest.mark.parametrize("cell", CELLS_AND_STANDBY)
def test_every_cell_and_standby_has_its_tiny_sizes(cell):
    """A cell joins the tests by a data file: its sizes on the CPU and on
    a card, each only of keys its configuration and mix have."""
    w = _cell(cell)
    cfg = load_json(ROOT, "configs", f"{w['config']}.json")
    mix = load_json(ROOT, "traffic", f"{w['traffic']}.json")
    for where in ("cpu", "card"):
        over = tiny(cell, where)
        assert set(over) <= {"config", "traffic"} and over["config"]
        assert set(over["config"]) <= set(cfg), over
        assert set(over.get("traffic", {})) <= set(mix), over


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
                       overrides=tiny(cell))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] >= 1
    assert res["failed"] == 0
    assert res["device"]["count"] == _cell(cell)["chips"]
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


def _loop(cell):
    return importlib.import_module(KINDS[_kind(cell)])


def _plant(port, cell, fault):
    """`fault` in the program: the loop's own `plant` where its module has
    one (the sharded loop plants on every rank), else faults.py's."""
    own = getattr(_loop(cell), "plant", None)
    return own(port, fault) if own else plant(port, _kind(cell), fault)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    port = run.import_port()
    with _plant(port, cell, fault):
        res = run.run_cell(cell, 2 ** 31 + 12, 0.2, False, device="cpu",
                           overrides=tiny(cell))
    assert not res["correct"], (fault, res["checks"])


# faults a loop has beyond the common three (the exchange between cards)
OWN_FAULTS = [(c, f) for c in CELLS
              for f in getattr(_loop(c), "FAULTS", FAULTS)
              if f not in FAULTS]


@pytest.mark.parametrize("cell,fault", OWN_FAULTS)
def test_a_loops_own_fault_is_not_correct(cell, fault):
    port = run.import_port()
    with _plant(port, cell, fault):
        res = run.run_cell(cell, 2 ** 31 + 15, 0.2, False, device="cpu",
                           overrides=tiny(cell))
    assert not res["correct"], (fault, res["checks"])


def test_kinds_are_found_by_file_name():
    assert KINDS == {"render": "portbench.drivers.render",
                     "progressive": "portbench.drivers.progressive",
                     "inverse": "portbench.drivers.inverse",
                     "sharded": "portbench.drivers.sharded"}
    for module in KINDS.values():
        assert hasattr(importlib.import_module(module), "Session")


@pytest.mark.parametrize("cell", CELLS)
def test_a_cells_ranks_are_its_chips(cell):
    assert load_json(ROOT, "traffic", f"{_cell(cell)['traffic']}.json").get(
        "ranks", 1) == _cell(cell)["chips"]


def _alive(pid):
    """A process that runs (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


DEAD_RANK = """
import os, signal, sys
sys.path.insert(0, {root!r})
from portbench import run
from portbench.drivers import sharded
setup = sharded.Session.setup

def setup_then_kill(self):
    setup(self)
    print("PIDS", *[p.pid for p in self.workers], flush=True)
    os.kill(self.workers[-1].pid, signal.SIGKILL)

sharded.Session.setup = setup_then_kill
run.run_cell({cell!r}, 2 ** 31 + 16, 300.0, False, device="cpu",
             overrides={over!r})
print("RESULT", flush=True)
"""


def test_a_dead_rank_ends_the_run():
    """A worker killed after set-up: the run fails long before its
    window of 300 s would end, prints no result, and leaves no process."""
    cell = next(c for c in CELLS if _kind(c) == "sharded")
    code = DEAD_RANK.format(root=ROOT, cell=cell, over=tiny(cell))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=200)
    took = time.monotonic() - t0
    assert out.returncode != 0 and "RESULT" not in out.stdout, out.stderr
    pids = [int(p) for p in out.stdout.split("PIDS", 1)[1].split()]
    assert pids and not any(_alive(p) for p in pids)
    assert took < 120, took


def test_each_rank_gets_its_own_cores(monkeypatch):
    from portbench.drivers import sharded
    cores = list(range(8))
    monkeypatch.setattr(sharded.os, "sched_getaffinity", lambda pid: cores)
    assert sharded._blocks(4) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert sharded._blocks(3) == [[0, 1], [2, 3], [4, 5]]
    assert sharded._blocks(16) == [[k] for k in range(8)] + [cores] * 8


def test_draws_split_is_the_ports():
    """`Draws.split` and `split_sample_seeds` give the draws of the
    port's `TorchDraws.split`, render after render."""
    from portbench.draws import Draws, Stream, split_sample_seeds
    seed, ranks, spp = 2 ** 31 + 17, 4, 3
    port = run.import_port()
    theirs = port.TorchDraws(seed, "cpu")
    mine = Draws(seed, "cpu")
    seeds = split_sample_seeds(seed, 2, ranks, spp)
    for render in range(2):
        for r, (a, b) in enumerate(zip(theirs.split(ranks),
                                       mine.split(ranks))):
            for k in range(spp):
                ja, sa = a.next_sample(5)
                jb, sb = b.next_sample(5)
                s = Stream(seeds[render][r][k], "cpu")
                assert torch.equal(ja, jb) and torch.equal(ja, s.jitter(5))
                for level in (0, 1):
                    assert torch.equal(sa.normal(level, 10),
                                       sb.normal(level, 10))
                    assert torch.equal(sa.normal(level, 10),
                                       s.normal(level, 10))


@pytest.mark.parametrize("w,h,ranks", [(16, 16, 2), (7, 5, 4), (1024, 1024, 4)])
def test_row_major_slice_is_the_ports(w, h, ranks):
    from portbench.layout import row_major_slice
    port = run.import_port()
    px, py, real = port.parallel.pixel_grid(w, h, pad_to=ranks)
    share = len(px) // ranks
    rank, idx, n = row_major_slice(px[:real], py[:real], w, h, ranks)
    assert n == share
    assert (rank == np.arange(real) // share).all()
    assert (idx == np.arange(real) % share).all()


def test_sharded_readers():
    events = [_event("portbench.render", False, 0, 1000),
              _event("rtx.all_gather", False, 100, 160),
              _event("rtx.all_gather", False, 600, 640),
              _event("void spawn_kernel<1>(SpawnArgs)", True, 10, 110),
              _event("shadow_shade_kernel(ShadowArgs)", True, 110, 150),
              _event("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)",
                     True, 150, 400),
              _event("ncclKernel_Broadcast_RING_LL_Sum_int8_t", True, 500,
                     520)]
    prof = Profile(SimpleNamespace(events=lambda: events), 1e-3)
    card = SimpleNamespace(device=torch.device("cuda"))
    r = run.Run(prof, 2, card, None, 0)
    assert run._read_metric("collective_ms.sharded4", r) == \
        pytest.approx(0.135)
    assert run._read_metric("gather_span_ms.sharded4", r) == \
        pytest.approx(0.05)
    assert run._read_metric("fused_kernel_ms.sharded4", r) == \
        pytest.approx(0.07)
    assert run._read_metric("device_idle_pct.sharded4", r) == \
        pytest.approx(59.0)
    off = run.Run(prof, 2, SimpleNamespace(device=torch.device("cpu")),
                  None, 0)
    assert run._read_metric("gather_span_ms.sharded4", off) is None


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
    chips = _cell(cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    res = run.run_cell(cell, 2 ** 31 + 13, 0.5, True,
                       overrides=tiny(cell, "card"))
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0 and res["metrics"]
