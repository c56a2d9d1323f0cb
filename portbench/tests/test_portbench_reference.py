"""The plain reference on the CPU: its own reading of the scenes equals
the program's, its closest hit keeps the reference's rules, and its
control (the reference computed in bfloat16, put in the program's place)
fails each cell's check at a tiny size."""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference import render as ref
from portbench.reference.scene import read_scene
from portbench.tests.test_portbench_harness import (CELLS_AND_STANDBY,
                                                    session_numbers)

ROOT = run.ROOT


@pytest.mark.parametrize("name", ["thai2.dae", "ico3_tex.dae"])
def test_scene_reading_equals_the_programs(name):
    port = run.import_port()
    path = os.path.join(ROOT, "data", name)
    mine = read_scene(path)
    scene = port.models.collada.ColladaLoader.from_file(
        path, width=64, height=64, verbose=False)
    theirs = scene.to_buffers()
    np.testing.assert_array_equal(mine["tri_verts"], theirs.tri_verts)
    np.testing.assert_array_equal(mine["tri_geom"], theirs.tri_geom)
    np.testing.assert_array_equal(mine["mat_rgb"], theirs.mat_diffuse_rgb)
    np.testing.assert_array_equal(mine["mat_tex"], theirs.mat_tex_id)
    np.testing.assert_array_equal(mine["light_pos"], theirs.light_pos)
    np.testing.assert_array_equal(mine["light_color"], theirs.light_color)
    np.testing.assert_array_equal(mine["atlas"], theirs.tex_atlas)
    cam = scene.cameras[0]
    for turn in (0.0, 0.05, -0.05):
        cam.add_y_angle(turn)
        mine["camera"].add_y_angle(turn)
        rotation, origin = mine["camera"].matrices()
        params = cam.params("cpu")
        np.testing.assert_array_equal(rotation, params.rot.numpy())
        np.testing.assert_array_equal(origin, params.origin.numpy())
        assert mine["camera"].max_xy == float(params.max_x)


def _tri(*v):
    return torch.tensor([v], dtype=torch.float32).reshape(1, 3, 3)


def test_closest_hit_rules():
    far = _tri(-1, -1, 5, 1, -1, 5, 0, 1, 5)
    near = _tri(-1, -1, 2, 1, -1, 2, 0, 1, 2)
    behind = _tri(-1, -1, -2, 1, -1, -2, 0, 1, -2)
    tris = torch.cat([far, near, behind, near])     # near twice: a tie
    o = torch.zeros((4, 3))
    d = torch.tensor([[0, 0, 1.0], [0, 0, -1.0], [1.0, 0, 0], [0, 0, 1.0]])
    alive = torch.tensor([True, True, True, False])
    t, i = ref.closest(o, d, tris, alive)
    assert t[0] == 2.0 and i[0] == 1                # nearest, lower index
    assert t[1] == 2.0 and i[1] == 2                # t >= 0 only
    assert math.isinf(t[2]) and math.isinf(t[3])     # parallel; dead
    # the blocks of pairs do not change the answer
    t2, i2 = ref.closest(o, d, tris, alive, pairs=1)
    assert torch.equal(t, t2) and torch.equal(i, i2)


@pytest.mark.parametrize("cell", sorted(CELLS_AND_STANDBY))
def test_control_fails_the_check(cell):
    """The reference in bfloat16 in the program's place reads beyond the
    cell's limits (at the cell's own size on the card, see PERF.md)."""
    numbers, limits = session_numbers(cell, 2 ** 31 + 21, control=True)
    assert any(numbers[k] > limits[k] for k in limits), numbers
