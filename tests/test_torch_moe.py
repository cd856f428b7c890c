"""CPU parity of the port's MoE family with the reference's.

* ``models/moe.py`` at the **published** ``capacity_factor`` 1.25 (d 64,
  8 experts top-2, one shared expert, rows of 64 tokens), with a router
  skewed so that assignments overflow their expert and are dropped: the
  routing and the integer dispatch state (``slots``, ``tok_of``,
  ``keep``, ``order``) equal the reference's with ``==``, the packed
  buffer too; ``y`` at the decode tests' ``atol=5e-4`` in float32
  (``tests/test_models.py:99``) and at the reference tests' bfloat16 bar
  2e-2; the aux loss at ``rel=1e-6`` (a float32 scatter-add, as the
  reference's). A router that sends every token to expert 0 keeps
  exactly its first ``cap`` tokens: the sort is stable.
* MLA (``models/attention.py``) at deepseek-v3's published head dims
  (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128; 2 heads, d_model
  256), so the flash-attention op sees D 192 with v zero-padded: the full
  pass against the reference's at both of its backends, and the absorbed
  decode step by step against the reference's and against the port's
  own full pass.
* The loss (cross-entropy, aux and deepseek's ``0.3 *`` MTP term) and
  its gradients, and a train step, on reduced moonshot-v1-16b-a3b and
  deepseek-v3-671b from the reference's weights (twins of
  ``test_smoke_train_step`` and ``test_moe_aux_loss_nonzero``), at the
  bars of ``tests/test_torch_train.py``; the remat policies carry the
  blocks' ``(x, aux)`` and change no number.

Inputs are made with NumPy from a seed and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config import reduced_config as ref_reduced_config
from repro.config.types import MLAConfig as RefMLAConfig
from repro.config.types import MoEConfig as RefMoEConfig
from repro.config.types import RunConfig as RefRunConfig
from repro.config.types import ShapeConfig as RefShapeConfig
from repro.config.types import TrainConfig as RefTrainConfig
from repro.models import attention as ref_attn
from repro.models import moe as ref_moe
from repro.models import runtime_flags
from repro.models.lm import build_model as ref_build_model
from repro.models.param import materialize as ref_materialize
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.state import TrainState as RefTrainState
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.config import (MLAConfig, MoEConfig, RunConfig,
                                ShapeConfig, TrainConfig, get_arch,
                                reduced_config)
from repro_torch.kernels.flash_attention.kernel import (takes_tensor_cores,
                                                       which_kernel)
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.convert import _unstack, load_reference_params
from repro_torch.models.lm import build_model
from repro_torch.train import AdamWConfig, TrainState, make_train_step
from repro_torch.utils.tree import tree_flatten_with_paths, tree_leaves

MOE_ARCHS = ["moonshot-v1-16b-a3b", "deepseek-v3-671b"]
ATOL = 5e-4                       # tests/test_models.py:99
BF16_ATOL = 2e-2                  # tests/test_kernels.py:32
LOSS_REL, PARAM_ATOL = 1e-5, 1e-5  # tests/test_train.py:67-70
GRAD_REL = 1e-4                   # tests/test_torch_train.py
T = 64                            # tokens per row (group)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(dtype)


# ------------------------------------------------------------ MoE dispatch
def _moe_cfgs():
    """Reduced moonshot with 8 experts top-2, one shared expert and the
    published capacity factor 1.25 (the reduced config's 4.0 drops
    nothing)."""
    kw = dict(n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=32,
              capacity_factor=1.25)
    name = "moonshot-v1-16b-a3b"
    return (dataclasses.replace(reduced_config(get_arch(name)),
                                moe=MoEConfig(**kw)),
            dataclasses.replace(ref_reduced_config(ref_get_arch(name)),
                                moe=RefMoEConfig(**kw)))


@pytest.fixture(scope="module")
def moe_case():
    """Params and inputs of one MoE layer: feature 0 of every token is 1
    and the router reads it as a bias towards experts 0 and 1, so rows of
    64 tokens overflow their capacity of 24."""
    cfg, ref_cfg = _moe_cfgs()
    params = _np(ref_materialize(ref_moe.moe_spec(ref_cfg),
                                 jax.random.PRNGKey(3), dtype=jnp.float32))
    params["router"] = np.array(params["router"])
    params["router"][0, :2] += np.array([1.5, 1.0], np.float32)
    # the reference's init takes a stack's first dim (E) as its fan-in;
    # scaled to the fan-in of each product (d, then f) the layer's
    # outputs are O(1), where bfloat16's 2e-2 bar is a few ulps
    e, d, f = params["wg"].shape
    for name, fan_in in (("wg", d), ("wi", d), ("wo", f)):
        params[name] = params[name] * np.float32(np.sqrt(e / fan_in))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, T, cfg.d_model)).astype(np.float32)
    x[..., 0] = 1.0
    return cfg, ref_cfg, params, x


def _ref_route(params, ref_cfg, x):
    logits = jnp.asarray(x, jnp.float32) @ jnp.asarray(params["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_i = jax.lax.top_k(probs, ref_cfg.moe.top_k)
    return top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9), top_i


def _ref_dispatch(x, top_i, cap, e, k):
    return jax.vmap(lambda xt, ti: ref_moe._dispatch_one_group(
        xt, ti, None, cap, e, k))(jnp.asarray(x), jnp.asarray(top_i))


def test_capacity_is_the_references():
    cfg, ref_cfg = _moe_cfgs()
    for n in (1, 16, 64, 100, 2048):
        assert moe._capacity(n, cfg) == ref_moe._capacity(n, ref_cfg)
    # the published shapes: 240 / 80 slots per expert per row at 2048
    # tokens (moonshot / deepseek), 8 for one decode token
    for name, want in (("moonshot-v1-16b-a3b", 240),
                       ("deepseek-v3-671b", 80)):
        full = get_arch(name)
        assert moe._capacity(2048, full) == want
        assert moe._capacity(1, full) == 8


def test_dispatch_state_equals_the_references_with_drops(moe_case):
    """Routing, dispatch state and buffer ``==`` the reference's, with
    assignments dropped. ``top_i ==`` is the check that would show a
    tie broken otherwise (``lax.top_k`` takes the lower index;
    ``torch.topk`` promises no order): with float32 softmax
    probabilities of random weights no tie occurs."""
    cfg, ref_cfg, params, x = moe_case
    m = cfg.moe
    cap = moe._capacity(T, cfg)
    _, top_p, top_i = moe.route(_torch(params), cfg, torch.from_numpy(x))
    ref_p, ref_i = _ref_route(params, ref_cfg, x)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(ref_i))
    # the router's float32 product sums in another order than XLA's
    np.testing.assert_allclose(top_p.numpy(), np.asarray(ref_p), rtol=1e-5)
    buf, state = moe.dispatch(torch.from_numpy(x), top_i, cap, m.n_experts)
    ref_buf, slots, tok_of, keep, order = _ref_dispatch(
        x, ref_i, cap, m.n_experts, m.top_k)
    assert int((~state.keep).sum()) > 0, "no assignment was dropped"
    for got, want in ((state.slots, slots), (state.tok_of, tok_of),
                      (state.keep, keep), (state.order, order)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(ref_buf))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, ATOL),
                                        (torch.bfloat16, BF16_ATOL)])
def test_moe_apply_matches_reference(moe_case, dtype, atol):
    """``y`` within ``atol`` of the reference's, in bfloat16 times each
    row's largest |value| (the bar ``chip_smoke.py`` holds bfloat16 to):
    the two libraries round silu and the products' outputs to bfloat16
    at other places, one ulp apart (2**-5 at the rows' largest values,
    about 4)."""
    cfg, ref_cfg, params, x = moe_case
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want, want_aux = ref_moe.moe_apply(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params),
        ref_cfg, jnp.asarray(x, jdt))
    got, aux = moe.moe_apply(_torch(params, dtype), cfg,
                             torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype and tuple(got.shape) == x.shape
    want = np.asarray(want, np.float32)
    scale = (np.abs(want).max(axis=-1, keepdims=True)
             if dtype == torch.bfloat16 else 1.0)
    assert np.all(np.abs(got.float().numpy() - want) <= atol * scale)
    assert aux.dtype == torch.float32
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    assert float(aux) > 0.0


def test_dropped_assignments_add_nothing(moe_case):
    """A token whose assignments were all kept gets its full routed
    mixture; a dropped assignment contributes zero: y equals the sum of
    the kept experts' outputs alone (float32, shared expert left out)."""
    cfg, _, params, x = moe_case
    p = _torch(params)
    del p["shared0"]
    solo = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_shared_experts=0))
    xt = torch.from_numpy(x)
    y, _ = moe.moe_apply(p, solo, xt)
    _, top_p, top_i = moe.route(p, solo, xt)
    _, state = moe.dispatch(xt, top_i, moe._capacity(T, solo), 8)
    kept = torch.zeros(top_i.shape, dtype=torch.bool)
    flat = kept.reshape(3, -1)
    flat.scatter_(1, state.order, state.keep)
    want = torch.zeros_like(xt)
    for j in range(solo.moe.top_k):
        e = top_i[..., j]
        h = torch.einsum("bsd,bsdf->bsf", xt, p["wg"][e])
        h = torch.nn.functional.silu(h) * torch.einsum(
            "bsd,bsdf->bsf", xt, p["wi"][e])
        out = torch.einsum("bsf,bsfd->bsd", h, p["wo"][e])
        want += torch.where(kept[..., j, None], top_p[..., j, None] * out,
                            0.0)
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)


def test_stable_sort_keeps_the_first_cap_tokens():
    """Every token's first choice is expert 0: of its 64 assignments the
    stable sort keeps tokens 0..cap-1, as the reference's."""
    cfg, _ = _moe_cfgs()
    cap = moe._capacity(T, cfg)
    top_i = torch.stack([torch.zeros(T, dtype=torch.int64),
                         1 + torch.arange(T) % 7], dim=-1)[None]
    x = torch.randn((1, T, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    _, state = moe.dispatch(x, top_i, cap, 8)
    to_expert0 = state.slots[0] < cap
    assert state.tok_of[0][to_expert0].tolist() == list(range(cap))
    assert int((~state.keep).sum()) == T - cap
    ref = _ref_dispatch(x.numpy(), top_i.numpy().astype(np.int32), cap, 8,
                        2)
    for got, want in zip(state, ref[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_combine_is_deterministic_and_ordered():
    """The combine adds a token's contributions in ascending expert order
    in the output's dtype, with no atomics: bfloat16 results equal a
    sequential sum in that order, bit for bit."""
    cfg, _ = _moe_cfgs()
    g = torch.Generator().manual_seed(1)
    out = torch.randn((2, 8, 24, 16), generator=g).to(torch.bfloat16)
    top_i = torch.stack([torch.randperm(8, generator=g)[:2]
                         for _ in range(2 * T)]).reshape(2, T, 2)
    top_p = torch.rand((2, T, 2), generator=g)
    x = torch.zeros((2, T, 16))
    _, state = moe.dispatch(x, top_i, 24, 8)
    y = moe.combine(out, top_p, state)
    y2 = moe.combine(out, top_p, state)
    assert torch.equal(y, y2)
    flat = torch.cat([out.reshape(2, 8 * 24, 16),
                      out.new_zeros((2, 1, 16))], dim=1)
    slot_of = torch.full((2, T * 2), 8 * 24)
    slot_of.scatter_(1, state.order, state.slots)
    slot_of = slot_of.reshape(2, T, 2)
    for b in range(2):
        for t in range(0, T, 7):
            acc = torch.zeros(16, dtype=torch.bfloat16)
            for j in torch.argsort(top_i[b, t]).tolist():
                w = top_p[b, t, j].to(torch.bfloat16)
                acc = acc + flat[b, slot_of[b, t, j]] * w
            assert torch.equal(y[b, t], acc)


# --------------------------------------------------------------------- MLA
def _mla_cfgs():
    kw = dict(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
              qk_rope_head_dim=64, v_head_dim=128)
    name = "deepseek-v3-671b"
    common = dict(d_model=256, n_heads=2, n_kv_heads=2, head_dim=None)
    return (dataclasses.replace(reduced_config(get_arch(name)),
                                mla=MLAConfig(**kw), **common),
            dataclasses.replace(ref_reduced_config(ref_get_arch(name)),
                                mla=RefMLAConfig(**kw), **common))


@pytest.fixture(scope="module")
def mla_case():
    cfg, ref_cfg = _mla_cfgs()
    params = _np(ref_materialize(ref_attn.attn_spec(ref_cfg),
                                 jax.random.PRNGKey(5), dtype=jnp.float32))
    x = np.random.default_rng(6).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    return cfg, ref_cfg, params, x


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_mla_apply_matches_reference(mla_case, backend, monkeypatch):
    monkeypatch.setattr(runtime_flags, "ATTN_BACKEND", backend)
    cfg, ref_cfg, params, x = mla_case
    want = ref_attn._mla_apply(jax.tree_util.tree_map(jnp.asarray, params),
                               ref_cfg, jnp.asarray(x), None)
    got = attn.attn_apply(_torch(params), cfg, torch.from_numpy(x))
    assert tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_mla_operands_take_the_tensor_core_kernel(mla_case):
    """The operands MLA hands to flash attention: q and k at D 192
    (nope 128 + rope 64), v zero-padded from 128 to 192; in bfloat16 they
    pass the tensor-core kernel's rule (dense, 16-byte aligned, strides
    multiples of 8), in float32 the split-TF32 kernel's."""
    cfg, _, params, x = mla_case
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attn.mla_operands(
            _torch(params, dtype), cfg, torch.from_numpy(x).to(dtype),
            torch.arange(x.shape[1]))
        assert q.shape == k.shape == v.shape == (2, 2, 12, 192)
        assert all(t.is_contiguous() for t in (q, k, v))
        assert torch.equal(v[..., 128:], torch.zeros_like(v[..., 128:]))
        # the rope key is one per position, shared by the heads
        assert torch.equal(k[:, 0, :, 128:], k[:, 1, :, 128:])
        assert takes_tensor_cores(q, k, v) == (dtype == torch.bfloat16)
        assert which_kernel(q, k, v) == ("tc" if dtype == torch.bfloat16
                                         else "f32tc")


def test_mla_decode_matches_reference_and_full_pass(mla_case):
    """The absorbed decode, one token at a time against the compressed
    cache, reproduces the reference's decode and the port's own expanded
    full pass (which runs the flash-attention op at D 192)."""
    cfg, ref_cfg, params, x = mla_case
    b, s, _ = x.shape
    p = _torch(params)
    ref_p = jax.tree_util.tree_map(jnp.asarray, params)
    full = attn.attn_apply(p, cfg, torch.from_numpy(x))
    (cache,) = attn.alloc_cache(
        [attn.attn_cache_spec(cfg, b, 16, dtype=torch.float32)], "cpu")
    assert set(cache) == {"ckv", "krope", "length"}
    assert tuple(cache["ckv"].shape) == (b, 16, 512)
    assert tuple(cache["krope"].shape) == (b, 16, 64)
    ref_cache = jax.tree_util.tree_map(
        lambda sd: jnp.zeros(sd.shape, sd.dtype),
        ref_attn.attn_cache_spec(ref_cfg, b, 16, dtype=jnp.float32))
    for t in range(s):
        pos = np.full((b,), t, np.int32)
        got, cache = attn.attn_decode(p, cfg, torch.from_numpy(x[:, t:t + 1]),
                                      cache, torch.from_numpy(pos))
        want, ref_cache = ref_attn._mla_decode(
            ref_p, ref_cfg, jnp.asarray(x[:, t:t + 1]), ref_cache,
            jnp.asarray(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(),
                                   atol=ATOL)
    assert cache["length"].tolist() == [s] * b
    np.testing.assert_allclose(cache["ckv"].numpy(),
                               np.asarray(ref_cache["ckv"]), atol=1e-5)


# ------------------------------------------------- loss and the train step
class _Carried:
    """A reduced MoE arch: the reference's model and float32 params, and
    the port's model with the same weights."""

    def __init__(self, name):
        self.cfg = reduced_config(get_arch(name))
        self.ref_cfg = ref_reduced_config(ref_get_arch(name))
        self.ref = ref_build_model(self.ref_cfg)
        self.params = self.ref.init(jax.random.PRNGKey(0), dtype=jnp.float32)
        self.port = build_model(self.cfg, device="cpu", dtype=torch.float32)
        load_reference_params(self.port, _np(self.params))
        rng = np.random.default_rng(11)
        v = self.cfg.vocab_size
        self.batch = {"tokens": rng.integers(0, v, (4, 16)).astype(np.int32),
                      "labels": rng.integers(0, v, (4, 16)).astype(np.int32)}

    def ref_by_path(self, params):
        tree = dict(_np(params))
        tree["layers"] = _unstack(tree["layers"], self.cfg.n_layers)
        return dict(tree_flatten_with_paths(tree))


@pytest.fixture(scope="module", params=MOE_ARCHS)
def carried(request):
    return _Carried(request.param)


def _jbatch(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def test_loss_and_grads_match_reference(carried):
    """Cross-entropy + aux (+ 0.3 MTP for deepseek) at ``rel=1e-5``, the
    aux and the MTP term on their own too; each gradient within ``1e-5``
    plus ``1e-4`` of its largest element of the reference's (float32's
    bar, ``tests/test_torch_train.py``)."""
    c = carried
    c.port.requires_grad_(True)
    loss = c.port.loss(c.batch)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: c.ref.loss(p, _jbatch(c.batch)))(c.params)
    assert float(loss.detach()) == pytest.approx(float(ref_loss),
                                                 rel=LOSS_REL)
    _, aux = c.port.forward(c.batch)
    _, ref_aux = c.ref.forward(c.params, _jbatch(c.batch))
    aux = float(aux.detach())
    assert aux > 0.0                    # test_moe_aux_loss_nonzero
    assert aux == pytest.approx(float(ref_aux), rel=1e-6)
    assert (c.port.mtp is not None) == (c.cfg.mtp_depth > 0)
    if c.port.mtp is not None:
        mtp = c.port._mtp_loss(c.batch, None)
        ref_mtp = c.ref._mtp_loss(c.params, _jbatch(c.batch), None)
        assert float(mtp.detach()) == pytest.approx(float(ref_mtp),
                                                    rel=LOSS_REL)
    paths = [p for p, _ in tree_flatten_with_paths(c.port.param_tree())]
    grads = dict(zip(paths, torch.autograd.grad(
        loss, tree_leaves(c.port.param_tree()))))
    want = c.ref_by_path(ref_grads)
    assert set(grads) == set(want)
    if c.port.mtp is not None:
        assert any(p.startswith("mtp/block/moe/") for p in grads)
    for path, g in grads.items():
        bound = PARAM_ATOL + GRAD_REL * np.abs(want[path]).max()
        err = np.abs(g.numpy() - want[path]).max()
        assert err <= bound, (path, err, bound)
    c.port.requires_grad_(False)


def test_train_step_matches_reference(carried):
    """One ``make_train_step`` step (remat ``"dots"``) from the carried
    weights against the reference's ``jit``ted step, with no warm-up so
    that the step's lr is not 0: loss, grad norm, then every parameter,
    which must have moved by more than 10x the parameters' ``atol``
    (twin of ``test_smoke_train_step``). Each parameter is held at
    ``atol=1e-5`` plus what the gradient's bar above (after the clip) can
    move AdamW's first step, ``lr * g / (|g| + eps)``, at that element of
    the reference's gradient ``g``: far below ``atol`` where ``|g|`` is
    well above the bar and ``eps``, up to ``2 * lr`` where ``g`` is 0 up
    to rounding and the step's sign is float32 noise in both packages."""
    c = carried
    load_reference_params(c.port, _np(c.params))
    train = TrainConfig(warmup_steps=0)
    run = RunConfig(arch=c.cfg, shape=ShapeConfig("t", 16, 4, "train"),
                    train=train)
    ref_run = RefRunConfig(arch=c.ref_cfg,
                           shape=RefShapeConfig("t", 16, 4, "train"),
                           train=RefTrainConfig(warmup_steps=0))
    state, m = make_train_step(c.port, run)(
        TrainState.init(c.port.param_tree(), AdamWConfig()), c.batch)
    ref_state, rm = jax.jit(ref_make_train_step(c.ref, ref_run))(
        RefTrainState.init(c.params, RefAdamWConfig()), _jbatch(c.batch))
    assert np.isfinite(float(m["loss"])) and int(state["step"]) == 1
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                             rel=LOSS_REL)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=GRAD_REL)
    lr = float(rm["lr"])
    assert lr == pytest.approx(train.learning_rate)
    grad = c.ref_by_path(jax.grad(
        lambda p: c.ref.loss(p, _jbatch(c.batch)))(c.params))
    clip = min(1.0, train.grad_clip / float(rm["grad_norm"]))

    def first_step(g):
        return g / (np.abs(g) + train.eps)

    want = c.ref_by_path(ref_state["params"])
    start = c.ref_by_path(c.params)
    moved = 0.0
    for path, t in tree_flatten_with_paths(state["params"]):
        g = clip * grad[path].astype(np.float64)
        d = clip * (PARAM_ATOL + GRAD_REL * np.abs(grad[path]).max())
        slack = lr * np.maximum(first_step(g + d) - first_step(g),
                                first_step(g) - first_step(g - d))
        err = np.abs(t.detach().numpy() - want[path])
        assert np.all(err <= PARAM_ATOL + slack), (
            path, err.max(), (err - slack).max())
        moved = max(moved, np.abs(want[path] - start[path]).max())
    assert moved > 10 * PARAM_ATOL, moved
    c.port.requires_grad_(False)
    load_reference_params(c.port, _np(c.params))


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_remat_carries_aux_and_changes_no_number(name):
    """The blocks return ``(x, aux)`` through every remat policy: losses
    and gradients equal with ``==`` under ``none``, ``dots`` and
    ``full``."""
    cfg = reduced_config(get_arch(name))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(5)).requires_grad_(True)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 16))}
    leaves = tree_leaves(model.param_tree())
    out = {}
    for remat in ("none", "dots", "full"):
        loss = model.loss(batch, remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for g, g0 in zip(out[remat][1], out["none"][1]):
            assert torch.equal(g, g0), remat
