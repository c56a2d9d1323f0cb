"""Checkpoint/resume for inverse-rendering runs (PyTorch port of
``raytracer_tpu/diff/checkpoint.py``).

The reference has no persistence at all (its film lives in memory and
dies on exit).  Long inverse renderings need it: the optimized
parameter dict, the optimizer's `state_dict()` and the step counter
round-trip to disk, one `torch.save` file per step, read back with
`torch.load(weights_only=True)` (plain dicts of tensors and numbers, no
pickled code).

    mgr = CheckpointManager("build/run1")
    mgr.save(step, params, optimizer.state_dict())
    step, params, opt_state = mgr.restore(params, optimizer.state_dict())
    optimizer.load_state_dict(opt_state)
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}.pt")

    def all_steps(self) -> list:
        """The steps on disk, oldest first."""
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                    os.listdir(self.directory))
                      if m)

    def save(self, step: int, params: dict, opt_state: dict) -> None:
        """Write step `step` (a temporary file renamed into place, so a
        crash never leaves half a checkpoint), then drop the oldest
        beyond `max_to_keep`."""
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"step": int(step),
                    "params": {k: v.detach().cpu() for k, v in params.items()},
                    "opt_state": opt_state}, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, params_like: dict, opt_state_like: dict):
        """Restore the latest checkpoint.  `params_like` gives the keys,
        devices and dtypes of the params; `opt_state_like` (an optimizer's
        `state_dict()`) the keys the optimizer state must have.  Returns
        (step, params, opt_state); raises FileNotFoundError if none
        exist."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        data = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        params = {k: data["params"][k].to(device=v.device, dtype=v.dtype)
                  for k, v in params_like.items()}
        opt_state = data["opt_state"]
        missing = set(opt_state_like) - set(opt_state)
        if missing:
            raise KeyError(f"checkpoint step {step}: optimizer state lacks "
                           f"{sorted(missing)}")
        return step, params, opt_state
