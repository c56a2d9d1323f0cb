"""The textured fused render on the CPU: a cell of the render loop whose
scene has a texture runs the fused path with the texel fetch on, and its
check fails when that fetch is left out (`faults.py`, "flat_texels"),
though the same run with the fetch passes.  Run with
`python -m pytest portbench/tests -q`."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.faults import TEXTURE_FAULTS, plant
from portbench.generator import load_json, make_session
from portbench.reference.scene import read_scene
from portbench.tests.test_portbench_harness import CELLS, ROOT, tiny


def _textured(cell):
    w = next(w for w in run.load_bench()["workloads"] if w["name"] == cell)
    cfg = load_json(ROOT, "configs", f"{w['config']}.json")
    mix = load_json(ROOT, "traffic", f"{w['traffic']}.json")
    if mix["kind"] != "render":
        return False
    return bool((read_scene(f"{ROOT}/{cfg['scene']}")["mat_tex"] >= 0).any())


# one-card render cells whose scene has a texture
TEXTURED = [c for c in CELLS if _textured(c)]


def test_a_textured_render_cell_exists():
    assert TEXTURED


@pytest.mark.parametrize("cell", TEXTURED)
def test_the_tiny_textured_render_fetches_texels(cell):
    w = next(w for w in run.load_bench()["workloads"] if w["name"] == cell)
    over = tiny(cell)
    cfg = run._merge(load_json(ROOT, "configs", f"{w['config']}.json"),
                     over.get("config"))
    mix = run._merge(load_json(ROOT, "traffic", f"{w['traffic']}.json"),
                     over.get("traffic"))
    session = make_session(run.import_port(), cfg, mix, 2 ** 31 + 31,
                           torch.device("cpu"), ROOT)
    session.setup()
    isect = session.rt.intersector
    assert session.rt.fused and isect.fused_has_textures
    assert isect.rec_format == cfg["records"] == "full"
    assert isect.shade_planes.shape[0] == 7
    # the records' texture id is >= 0 on some slot: the fetch has work
    assert (isect.shade_planes[6] >= 0).any()
    session.release()


@pytest.mark.parametrize("cell", TEXTURED)
@pytest.mark.parametrize("fault", (None,) + TEXTURE_FAULTS)
def test_the_texel_fetch_left_out_is_not_correct(cell, fault):
    seed = 2 ** 31 + 32
    if fault is None:
        res = run.run_cell(cell, seed, 0.2, False, device="cpu",
                           overrides=tiny(cell))
    else:
        with plant(run.import_port(), "render", fault):
            res = run.run_cell(cell, seed, 0.2, False, device="cpu",
                               overrides=tiny(cell))
    assert res["correct"] == (fault is None), res["checks"]
