"""CARAT on PyTorch and CUDA: the port of the ``repro`` package.

The package mirrors ``repro``'s layout module for module. It imports
``torch``, ``numpy`` and the standard library only: never ``jax`` and
nothing of ``repro``, whose jax-free modules it keeps as its own copies.

Two parts of the online co-tuning loop run on the card:

* the fleet state, stepped by :class:`repro_torch.storage.device.DeviceFleet`
  (``Simulation(backend="soa-torch")``, the default backend);
* the GBDT scoring, through the hand-written CUDA kernels of
  :mod:`repro_torch.kernels.gbdt_infer`.

Entry points take a ``device`` argument and run on ``cuda`` unless the
caller asks for ``"cpu"`` (:func:`repro_torch.device.resolve_device`).
"""
