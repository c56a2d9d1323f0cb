"""Intersection constants shared by the port's kernels and glue
(``raytracer_tpu/core/intersect.py``; its brute-force oracle is not
ported yet)."""

F32_EPSILON = 1.1920929e-07  # f32::EPSILON, matches intersect.rs:70
BIG_T = 3.0e38  # sentinel "no hit" distance (< f32 max, safe in arithmetic)
