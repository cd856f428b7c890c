"""Hand-written CUDA kernels of the port, one package per TPU kernel.

* :mod:`~repro_torch.kernels.gbdt_infer`: GBDT scoring (CARAT's tuner);
* :mod:`~repro_torch.kernels.flash_attention`: attention over a whole
  sequence (the LM stack's prefill and forward);
* :mod:`~repro_torch.kernels.decode_attention`: one token against a KV
  cache (the LM stack's decode step).

Each package holds ``csrc/*.cu`` (the kernels, built with ``nvcc`` for
``sm_90a`` at first CUDA use by :mod:`~repro_torch.kernels._build`),
``kernel.py`` (``ctypes`` binding, launch counters and the wrappers),
``ref.py`` (the plain torch versions) and ``ops.py`` (the public ops). A
wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises.
"""
