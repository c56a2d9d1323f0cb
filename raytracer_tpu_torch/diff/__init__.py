"""Differentiable rendering: gradients from pixels to scene parameters
(PyTorch port of ``raytracer_tpu/diff``).

New capability with no reference equivalent (the Rust tracer is forward
only).  Autograd runs through the brute-force path: discrete decisions
(closest-hit selection, shadow binarity, hemisphere flips, texel snap)
carry no gradient; the continuous shading and geometry terms
differentiate analytically.  The kernel intersectors refuse autograd.
"""
