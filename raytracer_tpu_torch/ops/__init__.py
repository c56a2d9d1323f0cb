"""BVH construction and the CUDA intersection kernels (PyTorch port of
``raytracer_tpu/ops``)."""
