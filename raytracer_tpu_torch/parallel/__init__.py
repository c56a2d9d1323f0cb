"""Multi-device rendering (PyTorch port of ``raytracer_tpu/parallel``).

The reference has no parallelism beyond a render-thread/GUI-thread split
(reference: raytracer/src/main.rs:194-253).  Here the pixel domain
shards over the ranks of a `torch.distributed` process group: a 1-D
mesh over rays, the scene replicated on every rank, NCCL between CUDA
cards and gloo between CPU processes.  Film statistics are all-gathered
and the replicated scene parameters' gradients all-reduced.
"""

from raytracer_tpu_torch.parallel.mesh import (RAY_AXIS, Mesh,
                                               initialize_distributed,
                                               make_mesh, ray_sharding,
                                               replicated)
from raytracer_tpu_torch.parallel.render import (make_sharded_frame_loop,
                                                 make_sharded_render,
                                                 make_sharded_train_step,
                                                 pixel_grid)

__all__ = ["RAY_AXIS", "Mesh", "initialize_distributed", "make_mesh",
           "ray_sharding", "replicated", "make_sharded_render",
           "make_sharded_frame_loop", "make_sharded_train_step",
           "pixel_grid"]
