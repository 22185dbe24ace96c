"""Device ops of the port: CUDA kernels (``csrc``), their wrappers and
plain versions, and the serving scorers."""
