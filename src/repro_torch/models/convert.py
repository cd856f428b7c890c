"""Carry the reference's weights, and its training state, into the
port's modules.

The reference keeps a model's parameters as a pytree of arrays
(``repro.models.lm.LanguageModel.init``); the port keeps them in
``nn.ParameterDict``s. Both use the same names and the same ``(in, out)``
weight layout, so loading is a copy, leaf by leaf: nested dicts (an MoE
block's router, its ``(E, d, f)``/``(E, f, d)`` expert stacks and
``shared{i}`` MLPs, MLA's norms), the MTP head's subtree (never
stacked), the SSM's and the RG-LRU's leaves, the frontend's projection
and the audio MLP's biases included. The reference stacks the layers of
a homogeneous stack (every leaf with a leading layer axis: the dense,
MoE, SSM and audio families) and keeps the hybrid's per-layer list;
both load. Every leaf takes its parameter's dtype
(``models.lm.param_dtype``: a bfloat16 model keeps the float32 specs in
float32, as the reference's ``init(key)`` does). This is the one place
that knows the mapping.
"""
from __future__ import annotations

import warnings
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
    arr = np.asarray(src)
    if arr.dtype.kind not in "biu":
        # floats, and NumPy's bfloat16 of the reference, through float32
        arr = arr.astype(np.float32, copy=False)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {arr.shape}, expected "
                         f"{tuple(dst.shape)}")
    with warnings.catch_warnings():
        # read only: copy_ reads the array, so it needs no host copy
        warnings.filterwarnings("ignore", message=".*not writable")
        dst.copy_(torch.from_numpy(arr).to(device=dst.device,
                                           dtype=dst.dtype))


def load_reference_params(model: LanguageModel,
                          params: Mapping) -> LanguageModel:
    """Load the reference's params (numpy arrays, or anything
    ``np.asarray`` takes) into ``model``, casting each to its
    parameter's dtype."""
    _copy_params(model.param_tree(), params, "params")
    return model


def load_reference_state(state: Mapping, ref_state: Mapping) -> Mapping:
    """Load a reference ``TrainState`` (``{"params", "opt": {"m", "v",
    "count"}, "step"}`` with NumPy leaves; its layers stacked or a list)
    into the port's ``state`` (``repro_torch.train.TrainState.init``) in
    place; returns ``state``."""
    _copy_params(state["params"], ref_state["params"], "params")
    for name in ("m", "v"):
        _copy_params(state["opt"][name], ref_state["opt"][name],
                     f"opt.{name}")
    _copy(state["opt"]["count"], ref_state["opt"]["count"], "opt.count")
    _copy(state["step"], ref_state["step"], "step")
    return state


def _copy_params(tree: Mapping, params: Mapping, where: str) -> None:
    if set(params.keys()) != set(tree.keys()):
        raise ValueError(f"{where}: expected top-level keys {sorted(tree)},"
                         f" got {sorted(params.keys())}")
    _copy(tree["embed"], params["embed"], f"{where}.embed")
    _copy(tree["final_norm"], params["final_norm"], f"{where}.final_norm")
    layers = _unstack(params["layers"], len(tree["layers"]))
    if len(layers) != len(tree["layers"]):
        raise ValueError(f"{where}: expected {len(tree['layers'])} layers, "
                         f"got {len(layers)}")
    for i, (dst, src) in enumerate(zip(tree["layers"], layers)):
        _copy(dst, src, f"{where}.layers[{i}]")
    if "mtp" in tree:
        _copy(tree["mtp"], params["mtp"], f"{where}.mtp")
