"""Multi-device rendering (port of `ilgpu_raytracing_tpu/parallel`)."""
