"""CARAT on PyTorch and CUDA: the port of the ``repro`` package.

The package mirrors ``repro``'s layout module for module. It imports
``torch``, ``numpy`` and the standard library only: never ``jax`` and
nothing of ``repro``, whose jax-free modules it keeps as its own copies.

Two paths run on the card:

* CARAT's online co-tuning loop: the fleet state, stepped by
  :class:`repro_torch.storage.device.DeviceFleet`
  (``Simulation(backend="soa-torch")``, the default backend), and the
  GBDT scoring, through the hand-written CUDA kernels of
  :mod:`repro_torch.kernels.gbdt_infer`;
* the LM serving path for the dense GQA family
  (:class:`repro_torch.models.LanguageModel`,
  :class:`repro_torch.serve.ServeEngine`), whose attention runs through
  the hand-written CUDA kernels of
  :mod:`repro_torch.kernels.flash_attention` (forward and prefill) and
  :mod:`repro_torch.kernels.decode_attention` (decode steps).

Entry points take a ``device`` argument and run on ``cuda`` unless the
caller asks for ``"cpu"`` (:func:`repro_torch.device.resolve_device`).
"""
