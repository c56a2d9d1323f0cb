#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (raytracer_tpu_torch) on one
NVIDIA card: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration (`portbench/configs/<config>.json`), its
traffic mix (`portbench/traffic/<mix>.json`, read by
`portbench/generator.py`), the limits of its check
(`portbench/checks/<workload>.json`) and its per-layer metrics
(`portbench/metrics/<metric>.py`) are found by name from
`BENCHMARK.json`.  A run builds the program and warms up every shape
the window uses (set-up), runs the mix's units back to back until
`--seconds` have passed (the window ends with the unit that crosses
it), then checks what the window produced against the plain reference
(`portbench/reference/`) once the program's state is freed.  The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics; with `--trace 1`,
read from a torch.profiler trace of the window, its per-layer ones),
`device`, with `--trace 1` `breakdown`, and last `checks`, each number
compared with its limit; the same numbers end standard error.

Without a CUDA card, with fewer cards than the cell asks for, without
the program beside this folder, or when the process has loaded JAX or
the JAX package, it prints no result and exits with a nonzero code.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run as a script, this folder is sys.path[0]; its modules are imported
# as portbench.<name> from ROOT, never by their bare names
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT,
                                                             "portbench"):
    del sys.path[0]
PORT = "raytracer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")


def environment():
    """Build and kernel caches at fixed paths inside the checkout; no
    library may bring JAX in."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def import_port():
    """The program beside this folder, and the modules the loops use."""
    if not os.path.isfile(os.path.join(ROOT, PORT, "__init__.py")):
        raise SystemExit(f"portbench: no {PORT}/ beside portbench/")
    import importlib
    port = importlib.import_module(PORT)
    for sub in ("ops.cuda_bvh", "models.collada", "models.camera",
                "diff.inverse", "diff.gradients"):
        importlib.import_module(f"{PORT}.{sub}")
    if not os.path.abspath(port.__file__).startswith(ROOT + os.sep):
        raise SystemExit(f"portbench: {PORT} loaded from {port.__file__}, "
                         "not from this checkout")
    return port


def load_bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _merge(base, over):
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (_merge(base[k], v) if isinstance(v, dict)
                  and isinstance(base.get(k), dict) else v)
    return out


def _cell_metrics(bench, workload, key):
    return [m for m in bench[key]
            if workload in m.get("workloads", [workload])]


def _read_metric(name, run):
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


class Run:
    """What a per-layer metric reader reads: the traced window's profile,
    the units completed in it, the session (the program as set up), the
    port, the seed."""

    def __init__(self, profile, units, session, port, seed):
        self.profile, self.units = profile, units
        self.session, self.port, self.seed = session, port, seed


def window(session, seconds, trace):
    """Units back to back until `seconds` have passed; returns their
    latencies, the window's seconds and (traced) the profiler."""
    import torch
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if session.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    latencies = []
    t_window = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if trace:
            with torch.profiler.record_function(f"portbench.{session.unit}"):
                dt = session.run_unit(t0)
        else:
            dt = session.run_unit(t0)
        latencies.append(time.perf_counter() - t0 if dt is None else dt)
        if time.perf_counter() - t_window >= seconds:
            break
    session.sync()
    window_s = time.perf_counter() - t_window
    if trace:
        prof.__exit__(None, None, None)
    return latencies, window_s, prof


def run_cell(workload, seed, seconds, trace, device="cuda", overrides=None):
    """One run of `workload`; returns the result line's object.
    `overrides` ({"config": {...}, "traffic": {...}}) changes sizes for
    tests on the CPU; the benchmark's own runs pass none."""
    import numpy as np
    import torch

    from portbench.generator import load_json, make_session
    from portbench.tracing import Profile

    overrides = overrides or {}
    bench = load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = _merge(load_json(ROOT, "configs", f"{cell['config']}.json"),
                 overrides.get("config"))
    mix = _merge(load_json(ROOT, "traffic", f"{cell['traffic']}.json"),
                 overrides.get("traffic"))
    limits = load_json(ROOT, "checks", f"{workload}.json")
    port = import_port()
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    session = make_session(port, cfg, mix, seed, dev, ROOT)
    session.setup()
    setup_s = time.perf_counter() - T_START

    latencies, window_s, prof = window(session, seconds, trace)
    q = [float(x) * 1e3 for x in np.percentile(latencies, [50, 95, 100])]
    print(f"portbench: {workload} seed {seed}: set-up {setup_s:.3f} s, "
          f"{len(latencies)} {session.unit}s in {window_s:.3f} s, each "
          f"{q[0]:.3f} / {q[1]:.3f} / {q[2]:.3f} ms at the median / 95th "
          "percentile / most", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": len(latencies), "failed": 0}
    if trace:
        reading = Profile(prof, window_s)
        del prof
        run = Run(reading, len(latencies), session, port, seed)
        metrics = {}
        for m in _cell_metrics(bench, workload, "per_layer"):
            value = _read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=reading.busy_s, window_s=window_s)
        breakdown = reading.breakdown()
        del run, reading
    else:
        values = dict(session.end_to_end(window_s, latencies),
                      setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in _cell_metrics(bench, workload, "end_to_end")}
    result.update(metrics=metrics, device=device)
    if trace:
        result["breakdown"] = breakdown

    got = session.kept()
    session.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = session.compare(got, session.reference(torch.float32))
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in checks.values())
    for c in checks.values():           # JSON has no infinity
        if c["value"] == float("inf"):
            c["value"] = None
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    bench = load_bench()
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              "card(s)", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
