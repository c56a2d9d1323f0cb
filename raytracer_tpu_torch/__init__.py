"""raytracer_tpu_torch — the PyTorch/CUDA port of `raytracer_tpu`.

The same wavefront ray tracer (COLLADA scenes, jittered pinhole rays,
the packed two-level BVH, the Morton cluster grid or brute force, Phong
shading with shadow rays, two bounce levels, film and tonemap), with its
closest-hit and fused wavefront kernels hand-written in CUDA for an
NVIDIA Hopper card (`ops/cuda_bvh.py`, `ops/cuda_cluster.py`,
`csrc/`).  `accel` picks the accelerator: "bvh" (default), "cluster"
or "brute".  `RayTracer.render_sharded` and `parallel/` shard the
pixels over the ranks of a `torch.distributed` group (NCCL between
cards, gloo between CPU processes); `diff/` differentiates the render.
Entry points run on `cuda` unless the caller passes `device="cpu"`,
which runs the kernels' plain PyTorch versions.  The package imports
neither JAX nor `raytracer_tpu`.

Public facade mirrors the reference library API
(raytracer_lib/src/lib.rs:15-44).
"""

from raytracer_tpu_torch.core.engine import (DEFAULT_TRIANGLES_PER_LEAF,
                                             RayTracer, TorchDraws,
                                             TorchStream)
from raytracer_tpu_torch.core.intersectors import make_intersector
from raytracer_tpu_torch.models.collada import ColladaLoader, SceneLoadError
from raytracer_tpu_torch.utils import stats

__version__ = "0.1.0"


def create_raytracer(collada_doc, triangles_per_leaf=DEFAULT_TRIANGLES_PER_LEAF,
                     width=1024, height=768, **kwargs):
    """Build a RayTracer from a COLLADA document string
    (reference: raytracer_lib/src/lib.rs:15-20)."""
    scene = ColladaLoader.from_str(collada_doc, data_dir=None, width=width,
                                   height=height)
    return RayTracer.from_scene(scene, width, height,
                                triangles_per_leaf=triangles_per_leaf, **kwargs)


def create_raytracer_from_file(collada_filename,
                               triangles_per_leaf=DEFAULT_TRIANGLES_PER_LEAF,
                               width=1024, height=768, **kwargs):
    """Build a RayTracer from a .dae file path
    (reference: raytracer_lib/src/lib.rs:22-27)."""
    scene = ColladaLoader.from_file(collada_filename, width=width,
                                    height=height)
    return RayTracer.from_scene(scene, width, height,
                                triangles_per_leaf=triangles_per_leaf, **kwargs)


__all__ = [
    "RayTracer",
    "TorchDraws",
    "TorchStream",
    "DEFAULT_TRIANGLES_PER_LEAF",
    "ColladaLoader",
    "SceneLoadError",
    "create_raytracer",
    "create_raytracer_from_file",
    "make_intersector",
    "stats",
]
