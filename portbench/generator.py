"""The one traffic generator: a mix is a data file,
``portbench/traffic/<mix>.json``, whose "kind" names the loop that
drives the program and whose other keys are that loop's parameters.

- "render": closed-loop batch renders, `RayTracer.render(spp)` into a
  fresh film, back to back.
- "progressive": closed-loop viewer frames, `trace_frame_additive()`
  then `get_tonemapped_pixels()`, with a camera move after every pass.
- "inverse": inverse-rendering steps of `diff.inverse.make_train_step`.
- "sharded": closed-loop `RayTracer.render_sharded(spp)` of one frame
  over `ranks` processes, one card each.

A mix of kind `k` is driven by `portbench/drivers/<k>.py`, found by its
file name, so a new loop is a new file.  Each loop is a session class
(`Session` in that file): `setup()` builds the program and warms up
every shape the window uses, `run_unit()` runs one render, frame or
step and returns its seconds, `end_to_end()` turns the window into the
cell's end-to-end metrics, `kept()` gives what the check compares,
`release()` frees the program's state, and `reference(dtype)` and
`compare(got, want)` compute the plain reference's answers and the
numbers compared.
"""

from __future__ import annotations

import importlib
import json
import os

DRIVERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "drivers")
# kind -> its loop: every module of portbench/drivers/ but the shared ones
KINDS = {f[:-3]: f"portbench.drivers.{f[:-3]}"
         for f in sorted(os.listdir(DRIVERS))
         if f.endswith(".py") and f not in ("__init__.py", "base.py")}


def load_json(root, *parts):
    with open(os.path.join(root, "portbench", *parts)) as f:
        return json.load(f)


def make_session(port, cfg, mix, seed, device, root):
    module = importlib.import_module(KINDS[mix["kind"]])
    return module.Session(port, cfg, mix, seed, device, root)
