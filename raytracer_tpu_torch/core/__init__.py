"""Core render pipeline: shading helpers, film, tonemap, the fused
wavefront and the engine (PyTorch port of ``raytracer_tpu/core``)."""
