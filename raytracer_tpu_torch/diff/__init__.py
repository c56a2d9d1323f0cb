"""Differentiable rendering: gradients from pixels to scene parameters
(PyTorch port of ``raytracer_tpu/diff``).

New capability with no reference equivalent (the Rust tracer is forward
only).  Autograd runs through the composable wavefront over any
intersector: discrete decisions (closest-hit selection, shadow
binarity, hemisphere flips, texel snap) carry no gradient; the
continuous shading and geometry terms differentiate analytically.  The
BVH and cluster intersectors are differentiable to the rays, with t
from their own copy of the triangles, as the JAX package's are.
"""
