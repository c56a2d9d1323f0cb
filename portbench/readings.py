#!/usr/bin/env python3
"""The readings that the limits of `portbench/checks/` are set from, at
a cell's own size, several seeds in one process (set-up is paid per seed,
the kernels' build once):

    python3 portbench/readings.py --workload <name> --seconds 5 \
        --seeds 11 12 13 [--control] [--faults unchanged half altered]

For each seed it runs the cell as a run does (set-up, a window of
`--seconds`, the check) and prints one JSON line with the numbers the
program's answers give against the float32 reference; `--control` adds
the numbers of the reference computed in bfloat16 put in the program's
place; `--faults` runs the program again with each planted fault
(portbench/faults.py).  Not part of a benchmark run.
"""

import argparse
import gc
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import run  # noqa: E402


def reading(port, cfg, mix, seed, seconds, device, control):
    import torch

    from portbench.generator import make_session
    session = make_session(port, cfg, mix, seed, device, run.ROOT)
    session.setup()
    latencies, window_s, _ = run.window(session, seconds, False)
    got = session.kept()
    session.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = session.reference(torch.float32)
    out = {"units": len(latencies), "window_s": window_s,
           "program": session.compare(got, want)}
    if control:
        out["control"] = session.compare(session.reference(torch.bfloat16),
                                         want)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.environment()
    import torch

    from portbench.faults import plant
    from portbench.generator import load_json
    bench = run.load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = load_json(run.ROOT, "configs", f"{cell['config']}.json")
    mix = load_json(run.ROOT, "traffic", f"{cell['traffic']}.json")
    port = run.import_port()
    device = torch.device(args.device)
    for seed in args.seeds:
        line = {"workload": args.workload, "seed": seed}
        line.update(reading(port, cfg, mix, seed, args.seconds, device,
                            args.control))
        for fault in args.faults:
            with plant(port, mix["kind"], fault):
                r = reading(port, cfg, mix, seed, args.seconds, device, False)
            line[f"fault_{fault}"] = r["program"]
        print(json.dumps(line), flush=True)
    found = run.forbidden_modules()
    if found:
        print(f"readings: the process loaded {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
