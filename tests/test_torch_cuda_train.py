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
included) and its backward op runs as often. Then the same families,
granite-3-2b and command-r-plus-104b in the reference's own training
configuration (bfloat16, ``parallel_for``'s remat, microbatches and
moments; ``_train_parity`` in bfloat16), held to the CPU's float64
gradient by 3x the CPU's bfloat16 distance from it, the card's update
to the CPU's AdamW on the card's gradients within an ulp; and K2's
forward launches of a
bfloat16 step at granite's D 64 and moonshot's D 128 all on its
``wgmma`` kernel. This file imports only the
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


# ------------------------------ the reference's training configuration
# every reduced family of ARCHS and granite's, at parallel_for's train
# settings of its published arch (deepseek-v3-671b and command-r-plus-104b
# take 4 microbatches and bfloat16 moments)
BF16_ARCHS = [("granite-3-2b", None)] + [(n, d) for n, d, _ in ARCHS] + [
    ("command-r-plus-104b", None)]


@pytest.mark.parametrize("name,depth", BF16_ARCHS)
def test_bf16_train_step_matches_the_cpu(dev, name, depth):
    """One bfloat16 step in the reference's training configuration on
    the card and on the CPU from the same weights (``chip_smoke.py``'s
    ``_train_parity`` in bfloat16, 8 x 64 tokens): each gradient the
    step hands AdamW no farther from the CPU's float64 gradient than 3x
    the CPU's bfloat16 gradient is, the grad norm likewise, the loss at
    ``rel=2e-2`` and the state at ``atol=2e-2``
    (``tests/test_torch_train_bf16.py``); the card's parameters within
    an ulp of the CPU's AdamW fed the card's gradients, at most 2 % of
    them apart, and a tenth of the bfloat16 weights moved; MoE
    dispatches differ only where the two routers cross; K2 on its
    ``wgmma`` kernel wherever the head dim is a multiple of 16."""
    from repro_torch.config.types import get_shape
    from repro_torch.launch.dryrun import parallel_for
    cfg = reduced_config(get_arch(name))
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    parallel = parallel_for(get_arch(name), get_shape("train_4k"))
    # every bar and launch count is gated inside: a miss raises
    out = chip_smoke._train_parity(dev, cfg, steps=1, dtype="bfloat16",
                                   parallel=parallel)
    assert out["grad_worst"]["err_over_bound"] <= 1.0
    assert out["grad_norm_err_over_bound"] <= 1.0
    assert out["replay"]["most_ulps"] <= 1
    assert out["bf16_weights_moved_share"] >= chip_smoke.MOVED_SHARE
    assert out["k2_launches_card"] == out["k2_forward_runs"]
    if out["k2_kernel"] == "tc":
        assert out["k2_tc_launches_card"] == out["k2_forward_runs"]
    assert out["microbatches"] == (4 if name in ("deepseek-v3-671b",
                                                 "command-r-plus-104b")
                                   else 1)


@pytest.mark.parametrize("name,layers", [("granite-3-2b", 2),
                                         ("moonshot-v1-16b-a3b", 1)])
def test_bf16_train_forward_launches_take_wgmma(dev, name, layers):
    """A bfloat16 train step at the published heads (granite's D 64,
    moonshot's D 128), cut to ``layers`` and a narrow batch: every K2
    forward launch, the stack's twice under ``remat="full"``, on the
    ``wgmma`` kernel, and its backward op once a block."""
    from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
    from repro_torch.config.types import get_shape
    from repro_torch.data import TokenSource, make_host_batch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch.dryrun import parallel_for
    from repro_torch.models.lm import build_model
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    published = get_arch(name)
    cfg = dataclasses.replace(published, n_layers=layers)
    parallel = parallel_for(published, get_shape("train_4k"))
    model = build_model(cfg, device=dev, dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(0))
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", 256, 2, "train"),
                    parallel=parallel, train=TrainConfig(warmup_steps=0))
    state = TrainState.init(model.param_tree(), AdamWConfig())
    step = make_train_step(model, run)
    batch = make_host_batch(cfg, 256, 2, TokenSource(cfg.vocab_size, 0), 0)
    fa.reset_launches()
    state, m = step(state, batch)
    torch.cuda.synchronize(dev)
    runs = chip_smoke.k2_forward_runs(model, parallel.remat)
    assert parallel.remat == "full" and runs == 2 * layers
    assert fa.launches["flash_attention"] == runs
    assert fa.launches["flash_attention_tc"] == runs
    assert fa.backward_calls["flash_attention_backward"] == layers
    assert bool(torch.isfinite(m["loss"]))
