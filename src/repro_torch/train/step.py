"""train_step / serve_step factories (the twin of ``repro/train/step.py``).

``make_train_step`` returns a function
    state, batch -> (state, metrics)
with microbatched gradient accumulation, the remat policy applied inside
the model, AdamW, global-norm clipping and a warmup-cosine schedule. The
reference's is a pure function under ``jit``; the port's runs eagerly on
the model's device and updates the state's tensors in place (the
parameters are the model's own, ``LanguageModel.param_tree()``).
Gradients come from ``torch.autograd.grad``; microbatches are a Python
loop that accumulates float32 gradients where the reference runs
``lax.scan``. Nothing in the step reads a value on the host: ``loss``,
``grad_norm`` and ``lr`` come back as 0-d tensors on the device. The
update runs inside the profiler range ``UPDATE_RANGE``, so a trace of a
step splits it into forward+backward and the AdamW update.

``make_prefill_step`` / ``make_decode_step`` are the serving entry points
(decode = one new token against the KV cache).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple

import torch

from repro_torch.config.types import RunConfig
from repro_torch.models.lm import LanguageModel
from repro_torch.parallel.constraints import constrain
from repro_torch.train.optimizer import AdamWConfig, adamw_update, global_norm
from repro_torch.train.schedule import warmup_cosine
from repro_torch.utils.tree import tree_leaves

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the profiler range around the AdamW update (clip included)
UPDATE_RANGE = "repro_torch::adamw_update"


def make_loss_fn(model: LanguageModel, run: RunConfig) -> Callable:
    """``batch -> loss`` of the model's own parameters."""
    remat = run.parallel.remat

    def loss_fn(batch: Mapping) -> torch.Tensor:
        return model.loss(batch, remat=remat)

    return loss_fn


def _on_device(batch: Mapping, device: torch.device) -> Dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _split_microbatches(batch: Dict, n: int) -> List[Dict]:
    """Microbatch ``i`` holds the rows ``[i·B/n, (i+1)·B/n)`` of each
    field, as the reference's reshape to ``(n, B/n, ...)`` gives them. On
    a mesh a microbatch's rows lie on a part of the devices the batch is
    split over: the slice gathers them (DTensor's all-gather) and the
    constraint splits the microbatch over the batch axes again."""
    rows = next(iter(batch.values())).shape[0] // n
    return [{k: constrain(x[i * rows:(i + 1) * rows],
                          ("act_batch",) + (None,) * (x.dim() - 1))
             for k, x in batch.items()} for i in range(n)]


def make_train_step(model: LanguageModel, run: RunConfig) -> Callable:
    """The train step of ``model``; makes its parameters trainable."""
    model.requires_grad_(True)
    loss_fn = make_loss_fn(model, run)
    opt_cfg = AdamWConfig(
        b1=run.train.b1, b2=run.train.b2, eps=run.train.eps,
        weight_decay=run.train.weight_decay,
        state_dtype=_STATE_DTYPES[run.parallel.opt_state_dtype])
    n_micro = run.parallel.microbatches

    def value_and_grad(params: List[torch.Tensor], batch: Dict):
        loss = loss_fn(batch)
        # a parameter the loss does not read (the token embedding of an
        # audio encoder fed frames) gets a zero gradient, as under jax.grad
        return loss.detach(), list(torch.autograd.grad(
            loss, params, materialize_grads=True))

    def train_step(state: Dict[str, Any],
                   batch: Mapping) -> Tuple[Dict, Dict]:
        params = tree_leaves(state["params"])
        batch = _on_device(batch, model.device)
        if n_micro > 1:
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            # each accumulator laid out as its parameter (on a mesh, its
            # shards)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in params]
            for mb in _split_microbatches(batch, n_micro):
                mb_loss, mb_grads = value_and_grad(params, mb)
                for acc, g in zip(grads, mb_grads):
                    acc.add_(g.to(torch.float32))
                loss = loss + mb_loss
            loss = loss / n_micro
            for g in grads:
                g.div_(n_micro)
        else:
            loss, grads = value_and_grad(params, batch)

        lr = warmup_cosine(state["step"], run.train.learning_rate,
                           run.train.warmup_steps, run.train.steps)
        gnorm = global_norm(grads)
        # grads: a list of the parameters' leaves, in the trees' order
        with torch.profiler.record_function(UPDATE_RANGE):
            new_params, new_opt = adamw_update(
                state["params"], grads, state["opt"], lr, opt_cfg,
                grad_clip=run.train.grad_clip)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_state, metrics

    return train_step


def make_prefill_step(model: LanguageModel, run: RunConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(batch: Mapping) -> torch.Tensor:
        """Full-prompt forward; returns last-position logits (B, V)."""
        logits, _ = model.forward(batch)
        return logits[:, -1]

    return prefill_step


def make_decode_step(model: LanguageModel, run: RunConfig) -> Callable:
    @torch.no_grad()
    def decode_step(tokens, cache, pos):
        """One new token per sequence against the KV cache."""
        logits, new_cache = model.decode_step(tokens, cache, pos)
        # on a mesh each device takes its rows' whole vocab first (DTensor's
        # argmax over a split vocab fails for a row per device)
        next_tok = torch.argmax(constrain(logits, ("act_batch", None)),
                                dim=-1).to(torch.int32)
        return next_tok, logits, new_cache

    return decode_step
