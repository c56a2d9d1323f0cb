"""The port's checkpoint/resume (diff/checkpoint.py): the three cases of
tests/test_checkpoint.py, with torch.optim in place of optax."""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.diff.checkpoint import CheckpointManager
from tests.test_torch_wavefront import torch_threads  # noqa: F401 (autouse)


def test_save_restore_roundtrip(tmp_path):
    """Params and Adam's state round-trip; a restored optimizer takes the
    next step exactly as the saved one does."""
    p = torch.tensor([[0.1, 0.2, 0.3]], requires_grad=True)
    opt = torch.optim.Adam([p], lr=1e-2)
    p.grad = torch.tensor([[1.0, -2.0, 0.5]])
    opt.step()
    params = {"mat_diffuse_rgb": p}

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, params, opt.state_dict())
    assert mgr.latest_step() == 3

    zeros = {"mat_diffuse_rgb": torch.zeros((1, 3), requires_grad=True)}
    opt2 = torch.optim.Adam(list(zeros.values()), lr=1e-2)
    step, restored, state = CheckpointManager(
        str(tmp_path / "ckpt")).restore(zeros, opt2.state_dict())
    assert step == 3
    np.testing.assert_allclose(restored["mat_diffuse_rgb"].numpy(),
                               p.detach().numpy(), rtol=1e-6)
    q = restored["mat_diffuse_rgb"].requires_grad_(True)
    opt2 = torch.optim.Adam([q], lr=1e-2)
    opt2.load_state_dict(state)
    for t, o in ((p, opt), (q, opt2)):
        t.grad = torch.tensor([[0.3, 0.3, -1.0]])
        o.step()
    assert torch.equal(p.detach(), q.detach())


def test_restore_empty_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        mgr.restore({}, {})


def test_max_to_keep(tmp_path):
    params = {"x": torch.zeros((2,), requires_grad=True)}
    st = torch.optim.SGD(list(params.values()), lr=1e-2).state_dict()
    mgr = CheckpointManager(str(tmp_path / "k"), max_to_keep=2)
    for i in range(4):
        mgr.save(i, params, st)
    assert mgr.latest_step() == 3
    assert len(mgr.all_steps()) <= 2
