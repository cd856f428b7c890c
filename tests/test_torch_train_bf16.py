"""CPU parity of the port's trainer with the reference's in the
reference's own training configuration: bfloat16 parameters and
compute (its ``model.init(key)`` default, ``ParamSpec.dtype``), the
remat, microbatch and moment settings of ``parallel_for``, and AdamW's
float32 arithmetic rounded once back to each dtype.

The weights are the reference's ``init(PRNGKey(0))`` at ``reduced_config``
widths, carried across by ``load_reference_params``: bfloat16, and the
float32 specs (the MoE router, the SSM's ``A_log``/``D``/``dt_bias``, the
RG-LRU's ``lam``) in float32 on both sides (``models.lm.param_dtype``).
The batches are made with NumPy from a seed. Against the reference's
``jax.jit(make_train_step(...))`` from the same state and batches, three
steps of every family (dense, sliding window, MoE with MLA and the MTP
head, SSM, hybrid, VLM, audio) under ``remat`` ``none`` and ``full``, and
the XXL settings (4 microbatches, bfloat16 moments) on reduced
command-r-plus-104b and deepseek-v3-671b.

The bars, and why each is the one it is:

* the loss of every step at ``rel=2e-2``, the bfloat16 bar of
  ``tests/test_kernels.py:32``;
* parameters and both moments after the last step at ``atol=2e-2``,
  the same bar;
* gradients are held to float64, not to the reference: the first
  step's gradients as the step hands them to AdamW (under remat, and
  summed over the XXL settings' microbatches), tensor by tensor, may be
  no farther from the float64 gradient of the same weights
  (``chip_smoke.float64_grads``) than 3x the reference's bfloat16
  gradient is (the rule of
  ``tests/test_torch_train.py::test_grads_as_close_to_float64_as_the_reference``).
  Only the first: from the second step on, the two sides' weights have
  parted by bfloat16 roundings, and each one's largest distance from its
  own float64 gradient is another draw (reduced deepseek-v3's MTP
  ``attn/wo`` at step 3: 3.6x the reference's, where step 1 holds).
  Every step's grad norm is no farther from the float64 norm than 3x
  the reference's gradient is from float64 in norm (the farthest its
  own grad norm may lie, by the triangle inequality). That norm bar is
  wide (reduced granite-3-2b: 3x the distance exceeds the whole float64
  norm, so a zero gradient would pass it alone); the tensor rule beside
  it is what holds the gradients. The reference's
  bfloat16 gradient is its jitted one, or, where that is closer,
  the same function run op by op (``jax.disable_jit``): XLA fuses
  chains of elementwise ops and keeps float32 between them, where an
  eager framework rounds each op's output to bfloat16. Run op by op
  the reference rounds as the port does and lands where the port does
  (reduced deepseek-v3's first MoE ``wg``: 1.226e-2 off float64, both;
  jitted 4.0e-3).
  A relative bar between the two libraries' grad norms does not hold in
  bfloat16, and not for the port's sake: the reference's jitted step and
  the same step op by op part by 3.4 %, 4.3 % and 5.4 % over three
  steps of reduced granite-3-2b, and both stand 35 % off the float64
  norm at its first step (9.7 and 9.9 against 15.1). The token
  embedding's gradient sets the norm; its input rows reach it through
  rmsnorm's backward over rows of scale 1/sqrt(vocab), where bfloat16
  cancels most digits;
* every step's update: the reference's ``adamw_update`` from what the
  port's took (parameters, handed gradients, moments, count, learning
  rate) gives what it gave, each bfloat16 element within one ulp (a
  bfloat16 moment whose two terms nearly cancel within their float32
  rounding, ``_replay_apart``) and at most 2 % of them apart, float32
  ones at ``rtol=1e-6, atol=1e-7``
  (``test_adamw_update_bf16_matches_reference`` says why not bit for
  bit); and at least a tenth of the bfloat16 weights moved. The steps
  run with no warm-up (``warmup_steps=0``) on both sides, so every step
  takes the peak learning rate of 3e-4: under the default 20 warm-up
  steps the rates would be 0, 1.5e-5 and 3e-5 and the weights would
  barely move, so a state left unchanged would pass the ``atol`` bar.

``adamw_update`` alone, on bfloat16 leaves with float32 and with
bfloat16 moments, is the reference's within one bfloat16 ulp, most
elements equal (``test_adamw_update_bf16_matches_reference``). The loss-falls rule of
``tests/test_train.py:73-87`` holds in bfloat16 over 8 steps, as the
reference's own step behaves under its 20 warm-up steps; over 3 it does
not (the first updates are below half a bfloat16 ulp of most weights
and the loss rises), so a card gate that wants a falling loss in 3
steps runs with ``warmup_steps=0``.
"""
import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import repro.models.moe as ref_moe
from repro.config import get_arch as ref_get_arch
from repro.config import reduced_config as ref_reduced_config
from repro.config.types import SHAPES as REF_SHAPES
from repro.config.types import ParallelConfig as RefParallelConfig
from repro.config.types import RunConfig as RefRunConfig
from repro.config.types import ShapeConfig as RefShapeConfig
from repro.config.types import TrainConfig as RefTrainConfig
from repro.launch.dryrun import parallel_for as ref_parallel_for
from repro.models.lm import build_model as ref_build_model
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.optimizer import adamw_update as ref_adamw_update
from repro.train.state import TrainState as RefTrainState
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.config import (ParallelConfig, RunConfig, ShapeConfig,
                                TrainConfig, get_arch, list_archs,
                                reduced_config)
from repro_torch.config.types import SHAPES, Family
from repro_torch.launch.dryrun import parallel_for
from repro_torch.models.convert import _unstack, load_reference_params
from repro_torch.models.lm import build_model
from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                               adamw_update, make_train_step)
from repro_torch.utils.tree import tree_flatten_with_paths, tree_leaves

BF16 = torch.bfloat16
# one arch of each family, and the sliding window
# (recurrentgemma at 3 layers: its third block is the local attention)
ARCHS = ["granite-3-2b", "h2o-danube-1.8b", "moonshot-v1-16b-a3b",
         "deepseek-v3-671b", "mamba2-370m", "recurrentgemma-2b",
         "paligemma-3b", "hubert-xlarge"]
DEPTH = {"recurrentgemma-2b": 3}
XXL_ARCHS = ["command-r-plus-104b", "deepseek-v3-671b"]
REMATS = ["none", "full"]
B, S, STEPS = 4, 16, 3
# the bfloat16 bar of tests/test_kernels.py:32
LOSS_REL, ATOL = 2e-2, 2e-2
# the rule of test_torch_train.py's
# test_grads_as_close_to_float64_as_the_reference
TIMES_REF = 3.0
# a step's AdamW against the reference's from the same inputs: each
# bfloat16 element within one ulp, at most this share of them apart
# (test_adamw_update_bf16_matches_reference says why)
REPLAY_APART = chip_smoke.REPLAY_APART
# the least share of the bfloat16 weights a step at the peak learning
# rate moves: five times REPLAY_APART, so that an update left undone
# fails the replay (3e-4 is more than half an ulp only of weights below
# ~0.1: 20-30 % of the reduced archs')
MOVED_SHARE = chip_smoke.MOVED_SHARE


def _batch(cfg, rng, b=B):
    """The family's inputs (``frames``; ``tokens`` with ``patches`` before
    them) and one label per text position, ``b`` rows."""
    out = {}
    if cfg.family == Family.AUDIO:
        out["frames"] = rng.standard_normal((b, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, S)).astype(
            np.int32)
    if cfg.family == Family.VLM:
        out["patches"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    return out


def _rows(batch) -> int:
    return next(iter(batch.values())).shape[0]


class _Carried:
    """The reference's reduced model with its default (bfloat16) params,
    and the port's bfloat16 model with the same weights."""

    def __init__(self, name):
        self.ref_cfg = ref_reduced_config(ref_get_arch(name))
        self.cfg = reduced_config(get_arch(name))
        if name in DEPTH:
            self.ref_cfg = dataclasses.replace(self.ref_cfg,
                                               n_layers=DEPTH[name])
            self.cfg = dataclasses.replace(self.cfg, n_layers=DEPTH[name])
        self.ref = ref_build_model(self.ref_cfg)
        self.params = self.ref.init(jax.random.PRNGKey(0))
        self.np_params = jax.tree_util.tree_map(np.asarray, self.params)
        self.port = build_model(self.cfg, device="cpu", dtype=BF16)
        self.reset()
        rng = np.random.default_rng(11)
        self.batches = [_batch(self.cfg, rng) for _ in range(STEPS)]
        # the XXL settings' batches: 4 microbatches of B rows each, the
        # shapes of the batches above (the op-by-op reference compiles
        # each op once per shape)
        self.xxl_batches = [_batch(self.cfg, rng, 4 * B)
                            for _ in range(STEPS)]
        self.m64 = build_model(self.cfg, device="cpu", dtype=torch.float64)
        self.paths = [p for p, _ in tree_flatten_with_paths(
            self.port.param_tree())]
        # the reference's gradient, jitted once, and op by op
        self.value_and_grad = jax.value_and_grad(
            lambda p, b: self.ref.loss(p, b, remat="none"))
        self.jitted = jax.jit(self.value_and_grad)
        self.memo = {}

    def reset(self):
        load_reference_params(self.port, self.np_params)

    def ref_by_path(self, tree, float64=True):
        """Path -> array of a reference tree (in float64, or in its own
        dtype), its stacked layers split per layer (the port's layout)."""
        tree = dict(jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float64 if float64 else None), tree))
        tree["layers"] = _unstack(tree["layers"], self.cfg.n_layers)
        return dict(tree_flatten_with_paths(tree))

    def truth(self, weights, batch, n_micro=1):
        """The float64 loss and gradients (path -> array) of ``weights``
        (a tree the port's loader takes) on ``batch``, its microbatches'
        mean as the step takes it; kept by the weights' and batch's bytes
        (the two trainers' weights agree at the first step, and remat
        changes no number)."""
        key = (_digest(weights), _digest(batch), n_micro)
        if key not in self.memo:
            self.memo[key] = self._truth(weights, batch, n_micro)
        return self.memo[key]

    def _truth(self, weights, batch, n_micro):
        load_reference_params(self.m64, weights)
        loss, grads = chip_smoke.float64_grads(
            self.cfg, tree_leaves(self.m64.param_tree()), batch, n_micro)
        return loss, dict(zip(self.paths, grads))


@functools.lru_cache(maxsize=None)
def _carried(name):
    return _Carried(name)


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    return _carried(request.param)


def _norm(grads):
    return float(np.sqrt(sum(float((g * g).sum()) for g in grads.values())))


def _port_weights(c):
    """The port's current weights as float64 NumPy arrays, in the
    loader's layout."""

    def conv(t):
        if hasattr(t, "items"):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        return t.detach().double().numpy()

    return conv(c.port.param_tree())


def _digest(tree) -> str:
    """A key of a tree's leaves' values (in float64, so that the same
    weights in bfloat16 and in float64 give one key)."""
    h = hashlib.sha1()
    for leaf in jax.tree_util.tree_leaves(tree):
        h.update(np.ascontiguousarray(np.asarray(leaf, np.float64))
                 .tobytes())
    return h.hexdigest()


def _ref_grads(c, params, batch, n_micro, jit=True):
    """The reference's gradients of ``params`` on ``batch`` as its step
    takes them: one ``value_and_grad`` (bfloat16 leaves), or the float32
    mean of the microbatches'; jitted, or run op by op (kept by the
    weights' and batch's bytes: it takes 7-34 s a gradient)."""
    key = (_digest(params), _digest(batch), n_micro, jit)
    if key not in c.memo:
        c.memo[key] = _ref_grads_of(c, params, batch, n_micro, jit)
    return c.memo[key]


def _ref_grads_of(c, params, batch, n_micro, jit):
    rows = _rows(batch) // n_micro
    total = None
    for i in range(n_micro):
        mb = {k: jnp.asarray(v[i * rows:(i + 1) * rows])
              for k, v in batch.items()}
        if jit:
            _, g = c.jitted(params, mb)
        else:
            with jax.disable_jit():
                _, g = c.value_and_grad(params, mb)
        if n_micro > 1:
            g = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), g)
        total = g if total is None else jax.tree_util.tree_map(
            jnp.add, total, g)
    if n_micro > 1:
        total = jax.tree_util.tree_map(lambda x: x / n_micro, total)
    return c.ref_by_path(total)


def _run_steps(c, remat, micro, opt_dtype, monkeypatch, batches=None):
    """STEPS steps of both trainers from the carried weights, with no
    warm-up (``warmup_steps=0``: every step takes the peak learning rate
    and moves the weights). Per step: both losses and grad norms, the
    gradients each step handed to AdamW (the reference's recomputed by
    ``_ref_grads``), the float64 gradients of each side's weights before
    the step, and what the port's AdamW took and gave (``update``).
    Returns the final states and the rows."""
    from repro_torch.train import step as step_mod
    c.reset()
    batches = c.batches if batches is None else batches
    b = _rows(batches[0])
    shape = ShapeConfig("t", S, b, "train")
    run = RunConfig(arch=c.cfg, shape=shape,
                    parallel=ParallelConfig(remat=remat, microbatches=micro,
                                            opt_state_dtype=opt_dtype),
                    train=TrainConfig(warmup_steps=0))
    ref_run = RefRunConfig(
        arch=c.ref_cfg, shape=RefShapeConfig("t", S, b, "train"),
        parallel=RefParallelConfig(remat=remat, microbatches=micro,
                                   opt_state_dtype=opt_dtype),
        train=RefTrainConfig(warmup_steps=0))
    state = TrainState.init(c.port.param_tree(), AdamWConfig(
        state_dtype=getattr(torch, opt_dtype)))
    step = make_train_step(c.port, run)
    ref_state = RefTrainState.init(c.params, RefAdamWConfig(
        state_dtype=jnp.dtype(opt_dtype)))
    ref_step = jax.jit(ref_make_train_step(c.ref, ref_run))
    updates = []
    update = step_mod.adamw_update

    def copies(tree):
        return [t.detach().clone() for t in tree_leaves(tree)]

    def recorded(params, grads, state, lr, cfg, grad_clip=0.0):
        took = {"params": copies(params), "grads": copies(grads),
                "m": copies(state["m"]), "v": copies(state["v"]),
                "count": int(state["count"]), "lr": float(lr), "cfg": cfg,
                "clip": grad_clip}
        params, new = update(params, grads, state, lr, cfg,
                             grad_clip=grad_clip)
        updates.append(dict(took, gave={"params": copies(params),
                                        "m": copies(new["m"]),
                                        "v": copies(new["v"])}))
        return params, new

    monkeypatch.setattr(step_mod, "adamw_update", recorded)
    rows = []
    for batch in batches:
        _, t_port = c.truth(_port_weights(c), batch, micro)
        ref_np = jax.tree_util.tree_map(np.asarray, ref_state["params"])
        _, t_ref = c.truth(ref_np, batch, micro)
        g_ref = _ref_grads(c, ref_state["params"], batch, micro)
        ref_before = ref_state["params"]
        state, m = step(state, batch)
        ref_state, rm = ref_step(
            ref_state, jax.tree_util.tree_map(jnp.asarray, batch))
        u = updates[-1]
        rows.append({"loss": float(m["loss"]), "ref_loss": float(rm["loss"]),
                     "gn": float(m["grad_norm"]),
                     "ref_gn": float(rm["grad_norm"]),
                     "grads": {p: g.double().numpy()
                               for p, g in zip(c.paths, u["grads"])},
                     "ref_grads": g_ref, "truth": t_port,
                     "ref_truth": t_ref, "ref_params": ref_before,
                     "batch": batch, "micro": micro, "update": u})
    assert len(updates) == STEPS
    return state, ref_state, rows


def _jnp(t: torch.Tensor):
    """A tensor as a JAX array of its own dtype (bfloat16 through
    float32, exactly)."""
    return jnp.asarray(t.detach().float().numpy()).astype(
        jnp.dtype(str(t.dtype).removeprefix("torch.")))


def _replay_apart(u) -> dict:
    """The reference's jitted ``adamw_update`` from what the port's AdamW
    took at one step (parameters, handed gradients, moments, count,
    learning rate, config and clip) against what it gave: per tree,
    ``(beyond, elements apart, elements, float32 pairs)``. ``beyond``
    counts the bfloat16 elements more than one ulp apart that a float32
    rounding of the moment's sum cannot explain: where ``b1 * m`` and
    ``(1 - b1) * g`` (``b2 * v`` and ``(1 - b2) * g * g``) nearly cancel,
    XLA's fused multiply-add and the port's two roundings part by up to
    an ulp of float32 of the terms, many bfloat16 ulps of the small sum
    (reduced deepseek-v3 at its XXL settings: 12 elements of 173,072 in
    ``m``). A parameter has no such cancellation: it takes one ulp."""
    cfg = u["cfg"]
    ref_cfg = RefAdamWConfig(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                             weight_decay=cfg.weight_decay,
                             state_dtype=jnp.dtype(str(cfg.state_dtype)
                                                   .removeprefix("torch.")))
    state = {"m": [_jnp(t) for t in u["m"]], "v": [_jnp(t) for t in u["v"]],
             "count": jnp.int32(u["count"])}
    params, state = jax.jit(lambda p, g, st, lr: ref_adamw_update(
        p, g, st, lr, ref_cfg, grad_clip=u["clip"]))(
        [_jnp(t) for t in u["params"]], [_jnp(t) for t in u["grads"]],
        state, jnp.float32(u["lr"]))
    g64 = [g.double().numpy() for g in u["grads"]]
    if u["clip"] > 0:
        norm = np.sqrt(sum(float((g * g).sum()) for g in g64))
        g64 = [g * min(1.0, u["clip"] / max(norm, 1e-12)) for g in g64]
    terms = {"params": [None] * len(g64),
             "m": [cfg.b1 * np.abs(m.double().numpy()) + (1 - cfg.b1)
                   * np.abs(g) for m, g in zip(u["m"], g64)],
             "v": [cfg.b2 * v.double().numpy() + (1 - cfg.b2) * g * g
                   for v, g in zip(u["v"], g64)]}
    out = {}
    for name, want in (("params", params), ("m", state["m"]),
                       ("v", state["v"])):
        beyond = apart = n = 0
        f32 = []
        for got, w, t in zip(u["gave"][name], want, terms[name]):
            w = torch.from_numpy(np.array(w, np.float32))
            if got.dtype != torch.bfloat16:
                f32.append((got, w))
                continue
            ulps = chip_smoke.ulps_apart(got, w)
            far = ulps > 1
            if t is not None:
                # two float32 roundings of the terms, then bfloat16's
                err = np.abs(got.double().numpy() - w.double().numpy())
                far &= err > 2 * 2.0 ** -24 * t + 2.0 ** -8 * np.abs(
                    w.double().numpy())
            beyond += int(far.sum())
            apart += int((ulps > 0).sum())
            n += ulps.size
        out[name] = (beyond, apart, n, f32)
    return out


def _dist(grads, truth, paths):
    """Per path the largest |grads - truth|, and the whole distance in
    norm."""
    per = {p: float(np.abs(grads[p] - truth[p]).max()) for p in paths}
    return per, _norm({p: grads[p] - truth[p] for p in paths})


def _yardstick(c, r):
    """The reference's bfloat16 distance from float64 at this step: per
    path and in norm, the larger of its jitted gradient's and its
    op-by-op gradient's (the latter only where the jitted one is closer
    than the port's rule needs: it takes 7-34 s a gradient)."""
    per, norm = _dist(r["ref_grads"], r["ref_truth"], c.paths)
    port, _ = _dist(r["grads"], r["truth"], c.paths)
    port_norm = abs(r["gn"] - _norm(r["truth"]))
    if (port_norm <= TIMES_REF * norm
            and all(port[p] <= TIMES_REF * per[p] + 1e-7 for p in c.paths)):
        return per, norm
    eager = _ref_grads(c, r["ref_params"], r["batch"], r["micro"],
                       jit=False)
    e_per, e_norm = _dist(eager, r["ref_truth"], c.paths)
    return {p: max(per[p], e_per[p]) for p in c.paths}, max(norm, e_norm)


def _check_steps(c, state, ref_state, rows, opt_dtype):
    """The module docstring's bars: losses at ``LOSS_REL``; the first
    step's handed gradients tensor by tensor, and every step's grad norm,
    by the float64 rule; every step's AdamW against the reference's from
    what it took, and the weights it moved; parameters and moments at
    ``ATOL``."""
    for k, r in enumerate(rows, start=1):
        assert r["loss"] == pytest.approx(r["ref_loss"], rel=LOSS_REL), (
            k, r["loss"], r["ref_loss"])
        # the grad norm the step reports is its gradients'
        assert r["gn"] == pytest.approx(_norm(r["grads"]), rel=1e-5)
        per, norm = _yardstick(c, r)
        if k == 1:
            port, _ = _dist(r["grads"], r["truth"], c.paths)
            for p in c.paths:
                assert port[p] <= TIMES_REF * per[p] + 1e-7, (
                    k, p, port[p], per[p])
        # with the gradients above: alone it would pass a zero gradient
        assert abs(r["gn"] - _norm(r["truth"])) <= TIMES_REF * norm, (
            k, r["gn"], _norm(r["truth"]), norm)
        for name, (beyond, apart, n, f32) in _replay_apart(
                r["update"]).items():
            assert beyond == 0 and apart <= REPLAY_APART * n, (
                k, name, beyond, apart, n)
            for got, want in f32:
                # test_torch_train.py::test_adamw_update_matches_reference
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-6, atol=1e-7)
        took, gave = r["update"]["params"], r["update"]["gave"]["params"]
        moved = sum(int((a != b).sum()) for a, b in zip(took, gave)
                    if a.dtype == BF16)
        n_bf16 = sum(a.numel() for a in took if a.dtype == BF16)
        assert moved >= MOVED_SHARE * n_bf16, (k, moved, n_bf16)
    assert int(state["step"]) == int(ref_state["step"]) == STEPS
    assert int(state["opt"]["count"]) == STEPS
    for name, got, want in (
            ("params", state["params"], ref_state["params"]),
            ("m", state["opt"]["m"], ref_state["opt"]["m"]),
            ("v", state["opt"]["v"], ref_state["opt"]["v"])):
        raw = c.ref_by_path(want, float64=False)
        want = c.ref_by_path(want)
        for path, t in tree_flatten_with_paths(got):
            # each leaf in the reference's dtype
            assert str(t.dtype) == f"torch.{raw[path].dtype.name}", (
                name, path, t.dtype, raw[path].dtype)
            np.testing.assert_allclose(t.detach().double().numpy(),
                                       want[path], atol=ATOL,
                                       err_msg=f"{name} {path}")


@pytest.mark.parametrize("remat", REMATS)
def test_train_steps_match_reference_bf16(carried, remat, monkeypatch):
    """Three steps of the reference's ``jit(make_train_step)`` and the
    port's, bfloat16 weights and float32 moments, from the same weights
    and batches, under ``remat`` none and full (``parallel_for``'s for a
    train shape): the bars of the module's docstring."""
    c = carried
    state, ref_state, rows = _run_steps(c, remat, 1, "float32",
                                        monkeypatch)
    _check_steps(c, state, ref_state, rows, "float32")


@pytest.mark.parametrize("name", XXL_ARCHS)
def test_xxl_train_steps_match_reference_bf16(name, monkeypatch):
    """``parallel_for``'s settings above 60 B parameters, 4 microbatches
    (bfloat16 gradients summed into float32 accumulators) of ``B`` rows
    and bfloat16 moments, on the reduced arch, ``remat="full"``: the
    same bars."""
    c = _carried(name)
    state, ref_state, rows = _run_steps(c, "full", 4, "bfloat16",
                                        monkeypatch, c.xxl_batches)
    _check_steps(c, state, ref_state, rows, "bfloat16")


# ------------------------------------------------------------ the dtypes
@pytest.mark.parametrize("name", sorted(set(ARCHS + XXL_ARCHS)))
def test_bf16_model_keeps_the_reference_param_dtypes(name):
    """A bfloat16 model holds each parameter in the dtype the reference's
    ``init(key)`` gives it: bfloat16, and float32 where the spec says so
    (the router, the SSM's ``A_log``/``D``/``dt_bias``, the RG-LRU's
    ``lam``); a float32 model holds them all in float32, as
    ``init(key, dtype=float32)``."""
    c = _carried(name)
    want = c.ref_by_path(c.params, float64=False)
    for path, t in tree_flatten_with_paths(c.port.param_tree()):
        assert str(t.dtype) == f"torch.{want[path].dtype.name}", (
            path, t.dtype, want[path].dtype)
    f32 = build_model(c.cfg, device="cpu", dtype=torch.float32)
    assert {t.dtype for t in tree_leaves(f32.param_tree())} == {
        torch.float32}


# ------------------------------------------------------- the gradients
@pytest.mark.parametrize("name", ARCHS)
def test_first_step_grads_as_close_to_float64_as_the_reference_bf16(name):
    """The first step's bfloat16 gradients, tensor by tensor, no farther
    from the float64 gradient of the same weights than 3x the
    reference's (its jitted gradient, or op by op where that is
    farther)."""
    c = _carried(name)
    c.reset()
    c.port.requires_grad_(True)
    batch = c.batches[0]
    gs = torch.autograd.grad(c.port.loss(batch),
                             tree_leaves(c.port.param_tree()),
                             materialize_grads=True)
    grads = {p: g.double().numpy() for p, g in zip(c.paths, gs)}
    _, truth = c.truth(c.np_params, batch)
    r = {"grads": grads, "truth": truth, "gn": _norm(grads),
         "ref_grads": _ref_grads(c, c.params, batch, 1),
         "ref_truth": truth, "ref_params": c.params, "batch": batch,
         "micro": 1}
    per, _ = _yardstick(c, r)
    port, _ = _dist(grads, truth, c.paths)
    for p in c.paths:
        assert port[p] <= TIMES_REF * per[p] + 1e-7, (p, port[p], per[p])


# ------------------------------------------------------- the MoE drops
DROP_S, DROP_B = 256, 2


def _differ(a, b) -> int:
    """Tokens whose experts (k per token, any order) differ."""
    return int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum())


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"])
def test_moe_drops_match_reference_bf16(name, monkeypatch):
    """The assignments dropped at the published capacity factor, the
    port's against the reference's: the reduced arch with its published
    routing (experts, top-k, capacity factor 1.25, shared experts; the
    expert FFN kept narrow), bfloat16 weights from the reference's
    ``init``, one forward of ``DROP_B`` rows of ``DROP_S`` seeded tokens.
    In bfloat16 a token whose k-th and next router probabilities nearly
    tie is routed otherwise by any change of rounding, so the reference's
    jitted run is held against its own op-by-op run (``jax.disable_jit``)
    as the yardstick: over all dispatches, the port's routing may differ
    from the jitted one in at most 3x as many tokens as the op-by-op one
    does (the 3x of the gradients' rule), and each dispatch's drop count
    (layer and row) may part from the jitted one by at most ``top_k`` a
    token routed otherwise (a moved assignment changes the count by at
    most one). The reference itself drops more than 1 % here: drops of
    that order at full width (``chip_smoke.py``'s moonshot train_4k cell)
    come from the seeded init's routing, which the reference shares."""
    ref_cfg = ref_reduced_config(ref_get_arch(name))
    cfg = reduced_config(get_arch(name))
    routing = {f: getattr(get_arch(name).moe, f) for f in (
        "n_experts", "top_k", "n_shared_experts", "capacity_factor")}
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
        ref_cfg.moe, **routing))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           **routing))
    ref = ref_build_model(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu", dtype=BF16)
    load_reference_params(port, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab_size, (DROP_B, DROP_S)).astype(
        np.int32) for k in ("tokens", "labels")}
    seen = []
    dispatch = ref_moe._dispatch_one_group

    def recorded(xt, top_i, top_p, cap, e, k):
        out = dispatch(xt, top_i, top_p, cap, e, k)
        jax.debug.callback(lambda d, t: seen.append((int(d), np.asarray(t))),
                           (~out[3]).sum(), top_i)
        return out

    monkeypatch.setattr(ref_moe, "_dispatch_one_group", recorded)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jax.jit(lambda p, b: ref.loss(p, b, remat="none"))(params, jb)
    jitted, seen[:] = list(seen), []
    with jax.disable_jit():
        ref.loss(params, jb, remat="none")
    eager = list(seen)
    with chip_smoke._Dispatches(keep_states=True) as disp, torch.no_grad():
        port.loss(batch)
    k = routing["top_k"]
    # the reference's callbacks: one per row, the rows of a call in order
    assert len(jitted) == len(eager) == DROP_B * len(disp.counts)
    port_moved = ref_moved = dropped = 0
    for c in range(len(disp.counts)):
        for g in range(DROP_B):
            ref_drops, ref_top = jitted[c * DROP_B + g]
            differ = _differ(disp.experts[c][g].numpy(), ref_top)
            mine = int((~disp.states[c][2][g]).sum())
            assert abs(mine - ref_drops) <= k * differ, (
                c, g, mine, ref_drops, differ)
            port_moved += differ
            ref_moved += _differ(eager[c * DROP_B + g][1], ref_top)
            dropped += ref_drops
    assert port_moved <= TIMES_REF * ref_moved, (port_moved, ref_moved)
    assert dropped > 0.01 * disp.assignments(), (dropped,
                                                 disp.assignments())


# --------------------------------------------------------------- AdamW
def _bf16_tree(rng, scale=1.0):
    """Leaves of bfloat16 values (as float32 NumPy arrays) in a layout
    whose spec order differs from JAX's sorted order."""
    def bf(shape):
        x = rng.normal(size=shape).astype(np.float32) * scale
        return torch.from_numpy(x).bfloat16().float().numpy()

    return {"b": [bf((33,)), bf((4, 5))], "a": bf((16, 8)),
            "c": {"z": bf((7,)), "y": bf((1,))}}


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tmap(fn, v) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_bf16_matches_reference(state_dtype, clip):
    """Three updates of bfloat16 leaves (float32 or bfloat16 moments)
    from the same values, gradients and learning rates against the
    reference's jitted ``adamw_update``: each bfloat16 element (the
    parameters, and bfloat16 moments) within one bfloat16 ulp of the
    reference's, most parameters equal; float32 moments at the float32
    test's ``rtol=1e-6, atol=1e-7``. Both compute each
    element in float32 by the same operations in the same order and
    round it once to the leaf's dtype and once to the state's (the
    reference's ``upd``; the port's ``copy_`` rounds to nearest even as
    ``astype`` does). Bit for bit it is not: XLA contracts ``b1 * m +
    (1 - b1) * g`` and its kin into fused multiply-adds, so about half
    the float32 moments lie a float32 ulp or more off the port's (1.2e-7
    at ~0.3; more ulps where the two terms cancel), and a bfloat16 leaf
    whose float32 value lies that close to a rounding midpoint rounds
    the other way: one bfloat16 ulp."""
    rng = np.random.default_rng(7)
    values = _bf16_tree(rng)
    cfg = AdamWConfig(weight_decay=0.1,
                      state_dtype=getattr(torch, state_dtype))
    ref_cfg = RefAdamWConfig(weight_decay=0.1,
                             state_dtype=jnp.dtype(state_dtype))
    port_p = _tmap(lambda x: torch.from_numpy(x.copy()).bfloat16(), values)
    port_s = adamw_init(port_p, cfg)
    ref_p = _tmap(lambda x: jnp.asarray(x).astype(jnp.bfloat16), values)
    ref_s = ref_adamw_init(ref_p, ref_cfg)
    update = jax.jit(lambda p, g, s, lr: ref_adamw_update(
        p, g, s, lr, ref_cfg, grad_clip=clip))
    apart = {}
    for i in range(STEPS):
        grads = _bf16_tree(rng, scale=3.0)
        lr = 1e-2 * (i + 1)
        port_p, port_s = adamw_update(
            port_p, _tmap(lambda x: torch.from_numpy(x.copy()).bfloat16(),
                          grads), port_s,
            torch.tensor(lr, dtype=torch.float32), cfg, grad_clip=clip)
        ref_p, ref_s = update(
            ref_p, _tmap(lambda x: jnp.asarray(x).astype(jnp.bfloat16),
                         grads), ref_s, jnp.float32(lr))
    for name, got, want in (("p", port_p, ref_p), ("m", port_s["m"],
                                                    ref_s["m"]),
                            ("v", port_s["v"], ref_s["v"])):
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert str(g.dtype) == f"torch.{w.dtype.name}"
            if g.dtype == torch.float32:
                # test_torch_train.py::test_adamw_update_matches_reference
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-7)
                continue
            ulps = chip_smoke.ulps_apart(
                g, torch.from_numpy(np.asarray(w, np.float32)))
            assert ulps.max() <= 1, (name, ulps.max())
            apart[name] = apart.get(name, 0) + int((ulps > 0).sum())
    # most bfloat16 parameters equal the reference's
    n = sum(t.numel() for t in tree_leaves(port_p))
    assert apart["p"] <= REPLAY_APART * n, apart
    assert int(port_s["count"]) == int(ref_s["count"]) == STEPS


# ------------------------------------------------------ the loss falls
def test_loss_decreases_over_steps_bf16():
    """``tests/test_train.py:73-87`` in bfloat16, as the reference's own
    step behaves there: 8 steps under the default 20 warm-up steps."""
    cfg = reduced_config(get_arch("h2o-danube-1.8b"))
    model = build_model(cfg, device="cpu", dtype=BF16)
    model.init(torch.Generator().manual_seed(0))
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", 16, 4, "train"),
                    parallel=ParallelConfig(remat="full"))
    state = TrainState.init(model.param_tree(), AdamWConfig())
    step = make_train_step(model, run)
    batch = {"tokens": np.zeros((4, 16), np.int32),
             "labels": np.zeros((4, 16), np.int32)}
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_loss_falls_in_three_steps_without_warmup_bf16():
    """What the card's 3-step gates rely on: with ``warmup_steps=0`` the
    first step takes the peak learning rate, and 3 bfloat16 steps on one
    batch lower the loss of reduced granite-3-2b under ``parallel_for``'s
    train settings."""
    from repro_torch.config import TrainConfig
    cfg = reduced_config(get_arch("granite-3-2b"))
    model = build_model(cfg, device="cpu", dtype=BF16)
    model.init(torch.Generator().manual_seed(0))
    shape = ShapeConfig("t", 16, 4, "train")
    run = RunConfig(arch=cfg, shape=shape, parallel=parallel_for(cfg, shape),
                    train=TrainConfig(warmup_steps=0))
    state = TrainState.init(model.param_tree(), AdamWConfig())
    step = make_train_step(model, run)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)),
             "labels": rng.integers(0, cfg.vocab_size, (4, 16))}
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


# ------------------------------------------------------ parallel_for
@pytest.mark.parametrize("name", list_archs())
def test_parallel_for_matches_reference(name, monkeypatch):
    """The port's ``parallel_for`` gives every cell the reference's
    settings (remat, microbatches, moment dtype, the rest), overrides
    unset; at reduced width none of the XXL settings apply."""
    for var in ("REPRO_SEQ_SHARD", "REPRO_MICROBATCHES", "REPRO_REMAT"):
        monkeypatch.delenv(var, raising=False)
    for shape, ref_shape in zip(SHAPES, REF_SHAPES):
        assert shape.name == ref_shape.name
        got = dataclasses.asdict(parallel_for(get_arch(name), shape))
        want = dataclasses.asdict(ref_parallel_for(ref_get_arch(name),
                                                   ref_shape))
        assert got == want, (name, shape.name)
    small = parallel_for(reduced_config(get_arch(name)), SHAPES[0])
    assert small.microbatches == 1 and small.opt_state_dtype == "float32"
