"""Carry the reference's weights into the port's modules.

The reference keeps a model's parameters as a pytree of arrays
(``repro.models.lm.LanguageModel.init``); the port keeps them in
``nn.ParameterDict``s. Both use the same names and the same ``(in, out)``
weight layout, so loading is a copy, leaf by leaf. This is the one
place that knows the mapping.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.models.lm import LanguageModel


def _unstack(layers: Any, n: int) -> List[Mapping]:
    """Per-layer dicts from the reference's stacked layout (every leaf
    with a leading layer axis, ``scan_layers=True``) or from its list."""
    if isinstance(layers, (list, tuple)):
        return list(layers)

    def take(tree, i):
        if isinstance(tree, Mapping):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    return [take(layers, i) for i in range(n)]


@torch.no_grad()
def _copy(dst, src: Any, where: str) -> None:
    if isinstance(dst, (dict, torch.nn.ParameterDict)):
        if not isinstance(src, Mapping) or set(src.keys()) != set(dst.keys()):
            have = sorted(src.keys()) if isinstance(src, Mapping) else src
            raise ValueError(f"{where}: expected keys {sorted(dst.keys())},"
                             f" got {have}")
        for k in dst.keys():
            _copy(dst[k], src[k], f"{where}.{k}")
        return
    arr = np.asarray(src).astype(np.float32)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {arr.shape}, expected "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr).to(device=dst.device, dtype=dst.dtype))


def load_reference_params(model: LanguageModel,
                          params: Mapping) -> LanguageModel:
    """Load the reference's params (numpy arrays, or anything
    ``np.asarray`` takes) into ``model``, casting to its dtype."""
    tree: Dict[str, Any] = model.param_tree()
    if set(params.keys()) != set(tree.keys()):
        raise ValueError(f"expected top-level keys {sorted(tree)}, got "
                         f"{sorted(params.keys())}")
    _copy(tree["embed"], params["embed"], "embed")
    _copy(tree["final_norm"], params["final_norm"], "final_norm")
    layers = _unstack(params["layers"], len(tree["layers"]))
    if len(layers) != len(tree["layers"]):
        raise ValueError(f"expected {len(tree['layers'])} layers, got "
                         f"{len(layers)}")
    for i, (dst, src) in enumerate(zip(tree["layers"], layers)):
        _copy(dst, src, f"layers[{i}]")
    return model
