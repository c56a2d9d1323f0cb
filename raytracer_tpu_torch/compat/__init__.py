"""Reference-compatibility layer (port of ``raytracer_tpu/compat``):
host-side mirrors of reference structures whose exact quirks the render
paths intentionally do not reproduce, kept for parity studies and oracle
tests."""
