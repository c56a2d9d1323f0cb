"""The port's CLI (raytracer_tpu_torch/cli.py) against the JAX package's:
the same flags, spellings and defaults (plus --device), an end-to-end
run on the CPU in a fresh process that imports no JAX, and a missing
scene file."""

import subprocess
import sys

import numpy as np

from raytracer_tpu.cli import build_parser as jax_parser
from raytracer_tpu_torch.cli import build_parser


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None)
            for a in parser._actions if a.dest != "help"}


def test_flags_and_defaults_match_reference():
    """Every JAX flag with its spellings, default, type and choices;
    the port adds --device (default cuda) and nothing else."""
    port, ref = _options(build_parser()), _options(jax_parser())
    assert set(port) - set(ref) == {"device"}
    for dest, spec in ref.items():
        assert port[dest] == spec, dest
    assert port["device"][:2] == (("--device",), "cuda")
    args = build_parser().parse_args([])
    assert vars(args) == {**vars(jax_parser().parse_args([])),
                          "device": "cuda"}


def test_short_flags():
    argv = ["-f", "x.dae", "-m", "30", "-i", "5", "--width", "64",
            "--height", "48", "--device", "cpu"]
    args = build_parser().parse_args(argv)
    ref = jax_parser().parse_args(argv[:-2])
    assert (args.file, args.max_triangles, args.frame_iterations) == \
        (ref.file, ref.max_triangles, ref.frame_iterations) == ("x.dae", 30, 5)
    assert (args.width, args.height, args.device) == (64, 48, "cpu")


def test_cli_end_to_end(tmp_path, data_dir):
    """`python -m raytracer_tpu_torch.cli` on 4boxes, two progressive
    frames over the fused BVH path on the CPU: the reference's prints
    and a PNG covering the whole (wrapped) image, with no JAX module
    loaded in the process."""
    out = tmp_path / "out.png"
    code = ("import runpy, sys; sys.argv = ['cli', '-f', "
            f"'{data_dir}/4boxes.dae', '-m', '70', '-i', '2', '--width', "
            f"'32', '--height', '24', '--out', '{out}', '--device', 'cpu']; "
            "rc = 0\n"
            "try:\n"
            "    runpy.run_module('raytracer_tpu_torch.cli', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print('JAX LOADED' if any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules) else 'NO JAX')\n"
            "sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "fps" in proc.stdout and "mean fps" in proc.stdout
    assert "max triangles: 70" in proc.stdout
    assert "frame iterations: 2" in proc.stdout
    assert proc.stdout.count("primary rays/s") == 3     # 2 frames + mean
    assert "NO JAX" in proc.stdout
    from PIL import Image
    img = np.asarray(Image.open(out))
    assert img.shape == (24, 32, 3)
    # rows_per_frame=50 wraps a 24-row image, so everything is sampled:
    # scene content (lit boxes) and black background must both appear
    assert (img.max(axis=-1) > 0).any()
    assert (img.max(axis=-1) == 0).any()


def test_cli_bad_file():
    proc = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch.cli", "-f", "missing.dae",
         "--device", "cpu"], capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "missing.dae" in proc.stderr
