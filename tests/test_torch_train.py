"""CPU parity of the port's trainer with the reference's.

Twins of ``tests/test_train.py`` (AdamW, the clip, the schedule,
microbatching, a falling loss, the global norm), then the port held to
``repro`` from the same inputs (made with NumPy from a seed; the weights
are the reference's ``model.init(PRNGKey(0), dtype=float32)`` carried
across by ``load_reference_params``, a reference train state by
``load_reference_state``):

* ``adamw_update``, ``global_norm`` and ``warmup_cosine`` on random trees
  and steps: the same float32 arithmetic in the same order, so equal to
  a few ulps (``rtol=1e-6``);
* the loss and its gradients, and three ``make_train_step`` steps, on
  reduced granite-3-2b and h2o-danube-1.8b under every remat policy
  and 1 or 2 microbatches: the loss at ``rel=1e-5`` and the parameters
  and moments at ``atol=1e-5``, the reference's own bar
  (``tests/test_train.py:67-70``); gradients within ``1e-5`` plus
  ``1e-4`` of each tensor's largest element (float32's conditioning,
  shown against a float64 gradient);
* remat changes no number: losses and gradients under ``none``,
  ``dots`` and ``full`` equal with ``==``, and ``dots`` recomputes no
  matrix product in backward where ``full`` recomputes the forward's;
* the flash-attention op's registered backward (the one a CUDA tensor
  takes) equals autograd through the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.config import get_arch as ref_get_arch
from repro.config import reduced_config as ref_reduced_config
from repro.config.types import ParallelConfig as RefParallelConfig
from repro.config.types import RunConfig as RefRunConfig
from repro.config.types import ShapeConfig as RefShapeConfig
from repro.models.lm import build_model as ref_build_model
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.optimizer import adamw_update as ref_adamw_update
from repro.train.optimizer import global_norm as ref_global_norm
from repro.train.schedule import warmup_cosine as ref_warmup_cosine
from repro.train.state import TrainState as RefTrainState
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.config import (ParallelConfig, RunConfig, ShapeConfig,
                                get_arch, reduced_config)
from repro_torch.kernels.flash_attention.kernel import flash_attention_op
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.convert import (_unstack, load_reference_params,
                                        load_reference_state)
from repro_torch.models.lm import build_model
from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                               adamw_update, global_norm, make_train_step,
                               warmup_cosine)
from repro_torch.utils.tree import tree_flatten_with_paths, tree_leaves

ARCHS = ["granite-3-2b", "h2o-danube-1.8b"]
REMATS = ["none", "dots", "full"]
B, S = 4, 16
# the reference's bar for a train step (tests/test_train.py:67-70)
LOSS_REL, ATOL = 1e-5, 1e-5
# gradients (and their norm): float32's rounding off a float64 gradient,
# see test_loss_and_grads_match_reference
GRAD_REL = 1e-4


def _t(x):
    # a copy: the port updates in place, and jnp.asarray may share the
    # NumPy buffer
    return torch.from_numpy(np.array(x, copy=True))


# ------------------------------------------------- twins of test_train.py
def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, cfg)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, state = adamw_update(params, g, state, lr=0.05, cfg=cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_grad_clip_caps_update_norm():
    cfg = AdamWConfig(weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = adamw_init(params, cfg)
    g = {"w": torch.full((4,), 1e6)}
    p2, _ = adamw_update(params, g, state, lr=0.1, cfg=cfg, grad_clip=1.0)
    assert float(p2["w"].abs().max()) < 1.0


def test_warmup_cosine_shape():
    lrs = [float(warmup_cosine(torch.tensor(s), 1e-3, 10, 100))
           for s in range(100)]
    assert lrs[0] == 0.0
    assert lrs[10] == pytest.approx(1e-3, rel=1e-3)
    assert lrs[99] < lrs[10]
    assert lrs[99] >= 1e-4 * 0.99      # min_frac floor


def _granite(seed=0):
    cfg = reduced_config(get_arch("granite-3-2b"))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    return cfg, model.init(torch.Generator().manual_seed(seed))


def test_microbatching_matches_full_batch():
    cfg, model = _granite()
    init = [p.detach().clone() for p in model.parameters()]
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)),
             "labels": rng.integers(0, cfg.vocab_size, (4, 16))}
    shape = ShapeConfig("t", 16, 4, "train")

    def run_with(n_micro):
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), init):
                p.copy_(p0)
        run = RunConfig(arch=cfg, shape=shape,
                        parallel=ParallelConfig(microbatches=n_micro,
                                                remat="none"))
        state = TrainState.init(model.param_tree(), AdamWConfig())
        new_state, m = make_train_step(model, run)(state, batch)
        return float(m["loss"]), [p.detach().clone() for p in
                                  tree_leaves(new_state["params"])]

    l1, p1 = run_with(1)
    l2, p2 = run_with(2)
    assert l1 == pytest.approx(l2, rel=1e-5)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_loss_decreases_over_steps():
    cfg = reduced_config(get_arch("h2o-danube-1.8b"))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", 16, 4, "train"),
                    parallel=ParallelConfig(remat="dots"))
    state = TrainState.init(model.param_tree(), AdamWConfig())
    step = make_train_step(model, run)
    batch = {"tokens": np.zeros((4, 16), np.int32),
             "labels": np.zeros((4, 16), np.int32)}
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(t)) == pytest.approx(5.0)


# ------------------------------------------ optimizer against the reference
def _random_tree(rng, scale=1.0):
    """Leaves in a layout whose spec order differs from JAX's sorted
    order (``b`` before ``a``; a list)."""
    return {"b": [rng.normal(size=(5,)) * scale,
                  rng.normal(size=(2, 3)) * scale],
            "a": rng.normal(size=(3, 4)) * scale,
            "c": {"z": rng.normal(size=(7,)) * scale,
                  "y": rng.normal(size=(1,)) * scale}}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _f32(x):
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adamw_update_matches_reference(clip):
    """Three updates of a random tree (gradients large enough to clip)
    with the reference's arithmetic: params and moments at ``rtol=1e-6``
    (equal operations in float32; a few ulps for the libraries' sqrt and
    pow), the count exactly."""
    rng = np.random.default_rng(7)
    params = _map(_f32, _random_tree(rng))
    cfg = AdamWConfig(weight_decay=0.1)
    ref_cfg = RefAdamWConfig(weight_decay=0.1)
    port_p = _map(_t, params)
    port_s = adamw_init(port_p, cfg)
    ref_p = _map(jnp.asarray, params)
    ref_s = ref_adamw_init(ref_p, ref_cfg)
    for i in range(3):
        grads = _map(_f32, _random_tree(rng, scale=3.0))
        lr = 1e-2 * (i + 1)
        port_p, port_s = adamw_update(port_p, _map(_t, grads), port_s,
                                      torch.tensor(lr, dtype=torch.float32),
                                      cfg, grad_clip=clip)
        ref_p, ref_s = ref_adamw_update(ref_p, _map(jnp.asarray, grads),
                                        ref_s, jnp.float32(lr), ref_cfg,
                                        grad_clip=clip)
    for got, want in ((port_p, ref_p), (port_s["m"], ref_s["m"]),
                      (port_s["v"], ref_s["v"])):
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    assert int(port_s["count"]) == int(ref_s["count"]) == 3


def test_global_norm_and_schedule_match_reference():
    tree = _map(_f32, _random_tree(np.random.default_rng(3), scale=10.0))
    assert float(global_norm(_map(_t, tree))) == pytest.approx(
        float(ref_global_norm(_map(jnp.asarray, tree))), rel=1e-6)
    for s in (0, 1, 7, 20, 21, 55, 199, 250):
        got = float(warmup_cosine(torch.tensor(s, dtype=torch.int32), 3e-4,
                                  20, 200))
        want = float(ref_warmup_cosine(jnp.asarray(s, jnp.int32), 3e-4, 20,
                                       200))
        assert got == pytest.approx(want, rel=1e-6), s


def test_tree_order_is_jax_order():
    tree = _map(_f32, _random_tree(np.random.default_rng(0)))
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = tree_flatten_with_paths(tree)
    assert [p for p, _ in got] == ["/".join(
        str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g is w


# ------------------------------------- the train step against the reference
class _Carried:
    """The reference's reduced model with its float32 params, and the
    port's model with the same weights."""

    def __init__(self, name):
        self.ref_cfg = ref_reduced_config(ref_get_arch(name))
        self.cfg = reduced_config(get_arch(name))
        self.ref = ref_build_model(self.ref_cfg)
        self.params = self.ref.init(jax.random.PRNGKey(0), dtype=jnp.float32)
        self.np_params = jax.tree_util.tree_map(np.asarray, self.params)
        self.port = build_model(self.cfg, device="cpu", dtype=torch.float32)
        self.reset()
        rng = np.random.default_rng(11)
        v = self.cfg.vocab_size
        self.batches = [
            {"tokens": rng.integers(0, v, (B, S)).astype(np.int32),
             "labels": rng.integers(0, v, (B, S)).astype(np.int32)}
            for _ in range(3)]

    def reset(self):
        load_reference_params(self.port, self.np_params)

    def ref_by_path(self, params):
        """Path -> array of a reference param tree, its stacked layers
        split per layer (the port's layout)."""
        tree = dict(jax.tree_util.tree_map(np.asarray, params))
        tree["layers"] = _unstack(tree["layers"], self.cfg.n_layers)
        return dict(tree_flatten_with_paths(tree))


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    return _Carried(request.param)


def _grads_by_path(model, loss):
    paths = [p for p, _ in tree_flatten_with_paths(model.param_tree())]
    return dict(zip(paths, torch.autograd.grad(
        loss, tree_leaves(model.param_tree()))))


def _port_grads(model, batch, remat):
    model.requires_grad_(True)
    loss = model.loss(batch, remat=remat)
    return float(loss.detach()), _grads_by_path(model, loss)


def _ref_grads(c, batch, remat):
    loss, grads = jax.value_and_grad(
        lambda p: c.ref.loss(p, jax.tree_util.tree_map(jnp.asarray, batch),
                             remat=remat))(c.params)
    return float(loss), c.ref_by_path(grads)


@pytest.mark.parametrize("remat", REMATS)
def test_loss_and_grads_match_reference(carried, remat):
    """The loss at ``rel=1e-5``; each gradient within ``1e-5`` plus
    ``GRAD_REL`` of its largest element of the reference's. The extra
    term is float32's, not the port's: the reference's own gradient is
    up to 8.8e-5 of the largest element off a float64 computation
    (granite's first ``wk``; its embedding 3.9e-5), and the next test
    holds the port as close to that as the reference."""
    c = carried
    c.reset()
    batch = c.batches[0]
    loss, grads = _port_grads(c.port, batch, remat)
    ref_loss, want = _ref_grads(c, batch, remat)
    assert loss == pytest.approx(ref_loss, rel=LOSS_REL)
    assert set(grads) == set(want)
    for path, g in grads.items():
        bound = ATOL + GRAD_REL * np.abs(want[path]).max()
        err = np.abs(g.numpy() - want[path]).max()
        assert err <= bound, (path, err, bound)


def test_grads_as_close_to_float64_as_the_reference(carried):
    """Against the gradient of the same weights in float64 (the model and
    the cross-entropy), the port's float32 gradient is off by at most 3x
    what the reference's float32 gradient is, tensor by tensor (1.2-2.2x
    measured: the two libraries round the same operations in other
    orders, and the embedding's input rows, reached through rmsnorm's
    backward, cancel digits in both). So the bound of the comparison
    above is float32's, not the port's."""
    c = carried
    c.reset()
    batch = c.batches[0]
    _, grads = _port_grads(c.port, batch, "none")
    _, want = _ref_grads(c, batch, "none")
    m64 = build_model(c.cfg, device="cpu", dtype=torch.float64)
    load_reference_params(m64, c.np_params).requires_grad_(True)
    logits, _ = m64.forward(batch)
    labels = torch.from_numpy(batch["labels"]).long()[..., None]
    loss = -torch.take_along_dim(torch.log_softmax(logits, dim=-1), labels,
                                 dim=-1).mean()
    truth = {p: g.numpy() for p, g in _grads_by_path(m64, loss).items()}
    for path, g in grads.items():
        port_err = np.abs(g.numpy() - truth[path]).max()
        ref_err = np.abs(want[path] - truth[path]).max()
        assert port_err <= 3 * ref_err + 1e-7, (path, port_err, ref_err)


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("remat", REMATS)
def test_train_steps_match_reference(carried, remat, micro):
    """Three steps of the reference's ``jit(make_train_step)`` and the
    port's from the same weights and batches: every step's loss, grad
    norm and lr, then every parameter and moment."""
    c = carried
    c.reset()
    shape = ShapeConfig("t", S, B, "train")
    run = RunConfig(arch=c.cfg, shape=shape,
                    parallel=ParallelConfig(remat=remat, microbatches=micro))
    ref_run = RefRunConfig(arch=c.ref_cfg,
                           shape=RefShapeConfig("t", S, B, "train"),
                           parallel=RefParallelConfig(remat=remat,
                                                      microbatches=micro))
    state = TrainState.init(c.port.param_tree(), AdamWConfig())
    step = make_train_step(c.port, run)
    ref_state = RefTrainState.init(c.params, RefAdamWConfig())
    ref_step = jax.jit(ref_make_train_step(c.ref, ref_run))
    for batch in c.batches:
        state, m = step(state, batch)
        ref_state, rm = ref_step(
            ref_state, jax.tree_util.tree_map(jnp.asarray, batch))
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                                 rel=LOSS_REL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=GRAD_REL)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert int(state["step"]) == int(ref_state["step"]) == 3
    assert int(state["opt"]["count"]) == 3
    for got, want in ((state["params"], ref_state["params"]),
                      (state["opt"]["m"], ref_state["opt"]["m"]),
                      (state["opt"]["v"], ref_state["opt"]["v"])):
        want = c.ref_by_path(want)
        for path, t in tree_flatten_with_paths(got):
            np.testing.assert_allclose(t.detach().numpy(), want[path],
                                       atol=ATOL, err_msg=path)


def test_reference_state_carries_over(carried):
    """A reference ``TrainState`` two steps in (stacked layers, moments
    and count non-zero) loaded by ``load_reference_state`` equals it leaf
    for leaf; one more step on each side then agrees at the bar."""
    c = carried
    run = RunConfig(arch=c.cfg, shape=ShapeConfig("t", S, B, "train"),
                    parallel=ParallelConfig(remat="dots"))
    ref_run = RefRunConfig(arch=c.ref_cfg,
                           shape=RefShapeConfig("t", S, B, "train"),
                           parallel=RefParallelConfig(remat="dots"))
    ref_step = jax.jit(ref_make_train_step(c.ref, ref_run))
    ref_state = RefTrainState.init(c.params, RefAdamWConfig())
    for batch in c.batches[:2]:
        ref_state, _ = ref_step(ref_state,
                                jax.tree_util.tree_map(jnp.asarray, batch))
    port = build_model(c.cfg, device="cpu", dtype=torch.float32)
    state = TrainState.init(port.param_tree(), AdamWConfig())
    load_reference_state(state, jax.tree_util.tree_map(np.asarray,
                                                       ref_state))
    assert int(state["step"]) == int(state["opt"]["count"]) == 2
    for got, want in ((state["params"], ref_state["params"]),
                      (state["opt"]["m"], ref_state["opt"]["m"]),
                      (state["opt"]["v"], ref_state["opt"]["v"])):
        want = c.ref_by_path(want)
        for path, t in tree_flatten_with_paths(got):
            np.testing.assert_array_equal(t.detach().numpy(), want[path])
    state, m = make_train_step(port, run)(state, c.batches[2])
    ref_state, rm = ref_step(ref_state, jax.tree_util.tree_map(
        jnp.asarray, c.batches[2]))
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                             rel=LOSS_REL)
    want = c.ref_by_path(ref_state["params"])
    for path, t in tree_flatten_with_paths(state["params"]):
        np.testing.assert_allclose(t.detach().numpy(), want[path],
                                   atol=ATOL, err_msg=path)


# ----------------------------------------------------------------- remat
class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ARCHS)
def test_remat_changes_no_number(name):
    """Losses and every gradient equal with ``==`` under the three
    policies. In backward, ``dots`` runs only the gradients' matrix
    products (as many as ``none``): the forward's are saved; ``full``
    recomputes the forward's too, so it runs more."""
    cfg = reduced_config(get_arch(name))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(5)).requires_grad_(True)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    leaves = tree_leaves(model.param_tree())
    out = {}
    for remat in REMATS:
        loss = model.loss(batch, remat=remat)
        with _CountMatmuls() as counter:
            grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss.detach(), grads, counter.n)
    loss0, grads0, n_none = out["none"]
    for remat in ("dots", "full"):
        loss, grads, _ = out[remat]
        assert torch.equal(loss, loss0), remat
        for g, g0 in zip(grads, grads0):
            assert torch.equal(g, g0), remat
    assert out["dots"][2] == n_none
    assert out["full"][2] > n_none


# -------------------------------------------------- the attention's gradient
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_flash_attention_op_backward_is_the_plain_versions(causal, window):
    """The op's registered backward (recompute the plain version, take its
    gradients) equals autograd through the plain version, exactly."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=g).requires_grad_(True) for s in
               ((2, 4, 12, 16), (2, 2, 12, 16), (2, 2, 12, 16)))
    grad_out = torch.randn((2, 4, 12, 16), generator=g)
    out = flash_attention_op(q, k, v, causal, window, None)
    got = torch.autograd.grad(out, (q, k, v), grad_out)
    want_out = flash_attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(want_out, (q, k, v), grad_out)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------ the serving steps
def test_prefill_and_decode_steps_match_reference(carried):
    """``make_prefill_step`` and ``make_decode_step`` against the
    reference's on the carried weights: last-position logits at the
    decode tests' ``atol=5e-4`` (``tests/test_models.py:99``), greedy
    tokens equal."""
    from repro.train.step import make_decode_step as ref_make_decode_step
    from repro.train.step import make_prefill_step as ref_make_prefill_step
    from repro_torch.train import make_decode_step, make_prefill_step
    c = carried
    c.reset()
    run = RunConfig(arch=c.cfg, shape=ShapeConfig("t", S, B, "train"))
    ref_run = RefRunConfig(arch=c.ref_cfg,
                           shape=RefShapeConfig("t", S, B, "train"))
    tokens = c.batches[0]["tokens"]
    got = make_prefill_step(c.port, run)({"tokens": tokens})
    want = ref_make_prefill_step(c.ref, ref_run)(
        c.params, {"tokens": jnp.asarray(tokens)})
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
    decode = make_decode_step(c.port, run)
    ref_decode = jax.jit(ref_make_decode_step(c.ref, ref_run))
    cache = c.port.init_cache(B, 8, dtype=torch.float32)
    ref_cache = c.ref.init_cache(B, 8, dtype=jnp.float32)
    for t in range(4):
        pos = np.full((B,), t, np.int32)
        tok, logits, cache = decode(torch.from_numpy(tokens[:, t]), cache,
                                    torch.from_numpy(pos))
        ref_tok, ref_logits, ref_cache = ref_decode(
            c.params, jnp.asarray(tokens[:, t]), ref_cache, jnp.asarray(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   atol=5e-4)
        assert tok.dtype == torch.int32
        assert tok.tolist() == np.asarray(ref_tok).tolist()
