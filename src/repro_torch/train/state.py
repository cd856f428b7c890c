"""Train state tree (the twin of ``repro/train/state.py``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.utils.tree import tree_leaves


def train_state_init(params, opt_cfg: AdamWConfig) -> Dict[str, Any]:
    """``{"params", "opt": {"m", "v", "count"}, "step"}``. ``params`` is
    the model's own tree (``LanguageModel.param_tree()``): the trainer
    updates those tensors in place, so the state and the model stay one."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    return {
        "params": params,
        "opt": adamw_init(params, opt_cfg),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


class TrainState:
    """Thin helper over the state dict."""

    @staticmethod
    def init(params, opt_cfg: AdamWConfig) -> Dict[str, Any]:
        return train_state_init(params, opt_cfg)

    @staticmethod
    def pspecs(param_pspecs):
        raise NotImplementedError(
            "TrainState.pspecs waits for the port's parallel/ slice "
            "(ROADMAP Queue 1)")
