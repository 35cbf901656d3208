"""Static checks of the port: ``smem``, the shared-memory audit of the
CUDA kernels against a committed baseline, with its ``findings``."""
