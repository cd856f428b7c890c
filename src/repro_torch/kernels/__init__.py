"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each package holds ``csrc/*.cu`` (the kernels, built with ``nvcc`` for
``sm_90a`` at first CUDA use), ``kernel.py`` (build, ``ctypes`` binding,
launch counters and the wrappers), ``ref.py`` (the plain torch versions)
and ``ops.py`` (the public scorers). A wrapper runs the plain version
only for tensors on the CPU; for a CUDA tensor it launches its kernel or
raises.
"""
