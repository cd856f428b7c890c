"""A train step of every family on a CUDA device against the CPU's.

Every test here is marked ``cuda`` and skips without a CUDA device. For
the reduced MoE (moonshot, deepseek with MLA and its MTP head), SSM
(mamba2), hybrid (recurrentgemma at 3 layers, its third block the local
attention), VLM (paligemma), audio (hubert) and sliding-window
(h2o-danube, window 8 in 32-token rows) archs, one train step on the
card and one on the CPU start from the same float32 weights with no
warm-up, so the step moves the weights, through ``chip_smoke.py``'s
``_train_parity`` at 4 x 32 tokens: its loss at the reference's
``rel=1e-5`` (``tests/test_train.py:67-70``), its grad norm at
``rel=1e-4``, each gradient within ``1e-5`` plus ``1e-4`` of its
largest element (``tests/test_torch_train.py``), and the parameters
after it at the reference's ``atol=1e-5`` of the CPU's step, plus, where
the CPU's gradient lies within its bar of 0, what the bar can move
AdamW's step there (``_Updates.slack``); also at ``atol`` of the CPU's
AdamW fed the card's gradients. The MoE dispatch states equal the CPU's.
K2 (the split-TF32 kernel) launches once per attention block (the MTP head's
included) and its backward op runs as often. This file imports only the
port, ``chip_smoke.py``, NumPy and torch, so it runs on a machine
without JAX::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_train.py
"""
import dataclasses

import pytest
import torch

import chip_smoke
from repro_torch.config import get_arch, reduced_config

pytestmark = pytest.mark.cuda

# (arch, depth cut, attention blocks of a training forward: the stack's
# and deepseek's MTP block; none in mamba2, the third block of the hybrid)
ARCHS = [("moonshot-v1-16b-a3b", None, 2), ("deepseek-v3-671b", None, 3),
         ("mamba2-370m", None, 0), ("recurrentgemma-2b", 3, 1),
         ("paligemma-3b", None, 2), ("hubert-xlarge", None, 2),
         ("h2o-danube-1.8b", None, 2)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name,depth,blocks", ARCHS)
def test_train_step_matches_the_cpu(dev, name, depth, blocks):
    cfg = reduced_config(get_arch(name))
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    # every bar and launch count is gated inside: a miss raises
    out = chip_smoke._train_parity(dev, cfg, steps=1, seq=32, batch=4,
                                   seeds=(2, 3))
    assert out["attention_blocks"] == blocks
    assert out["k2_launches_card"] == blocks
    assert out["flash_attention_backward_op_calls"] == blocks
    assert out["k2_launches_cpu"] == 0
    assert out["param_worst"]["err_over_bound"] <= 1.0
    assert out["param_vs_card_grads_replay"] <= out["atol"]
    assert out.get("moe", {"dispatch_states_equal": True})[
        "dispatch_states_equal"]
