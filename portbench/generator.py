"""The one traffic generator: a mix is a data file,
``portbench/traffic/<mix>.json``, whose "kind" names the loop that
drives the program and whose other keys are that loop's parameters.

- "render": closed-loop batch renders, `RayTracer.render(spp)` into a
  fresh film, back to back.
- "progressive": closed-loop viewer frames, `trace_frame_additive()`
  then `get_tonemapped_pixels()`, with a camera move after every pass.
- "inverse": inverse-rendering steps of `diff.inverse.make_train_step`.

Each loop is a session class (`portbench/drivers/`): `setup()` builds
the program and warms up every shape the window uses, `run_unit()` runs
one render, frame or step and returns its seconds, `end_to_end()` turns
the window into the cell's end-to-end metrics, `kept()` gives what the
check compares, `release()` frees the program's state, and
`reference(dtype)` and `compare(got, want)` compute the plain
reference's answers and the numbers compared.
"""

from __future__ import annotations

import importlib
import json
import os

KINDS = {"render": "portbench.drivers.render",
         "progressive": "portbench.drivers.progressive",
         "inverse": "portbench.drivers.inverse"}


def load_json(root, *parts):
    with open(os.path.join(root, "portbench", *parts)) as f:
        return json.load(f)


def make_session(port, cfg, mix, seed, device, root):
    module = importlib.import_module(KINDS[mix["kind"]])
    return module.Session(port, cfg, mix, seed, device, root)
