"""CPU parity of the port's LM stack with the reference's.

At ``reduced_config`` of the ten archs the port carries (granite-3-2b,
full causal attention; internlm2-20b, GQA 4/1 at reduced width, untied
head; command-r-plus-104b, tied, the bias-free layernorm;
h2o-danube-1.8b, sliding window 8, untied head;
mamba2-370m, the SSD mixer; recurrentgemma-2b, the RG-LRU hybrid;
paligemma-3b, image patches before the text; moonshot-v1-16b-a3b, MoE 4
experts top-2; deepseek-v3-671b, MLA and MoE with a shared expert, the
MTP head; hubert-xlarge, the bidirectional audio encoder over frames),
and recurrentgemma-2b at 3 layers (the reduced 2-layer hybrid has no
attention block; the third is the local-attention block with its
window-8 ring buffer), the reference's weights (``repro``'s
``model.init(PRNGKey(1), dtype=float32)``) go through
``load_reference_params`` into the port. Then the forward logits, the
step-by-step decode logits (danube's and the hybrid's ring buffers
wrap) and the serving engine's greedy tokens must match the reference's,
at the decode tests' ``atol=5e-4`` (``tests/test_models.py:99``). The
reference's forward runs once through its Pallas kernels too
(``runtime_flags.ATTN_BACKEND`` patched to ``"pallas"``), so the slice
is held against both. The MoE archs' router aux loss is held to the
reference's at ``rel=1e-6``. hubert (``decoder=False``) runs forward
and loss only, as the reference's tests run it (``DECODER_ARCHS``).

The reduced 2-layer hybrid is homogeneous (two recurrent blocks), so
the reference stacks its specs, and a stacked spec's fan-in is its first
dim, the layer count: its weights are ~6x the per-layer init's and its
activations reach ~1e3. float32 rounding then moves its logits by up to
~5e-4 (the reference's own scanned and per-layer forwards differ by
8.3e-4 on the forward test's tokens); the port is held to the same bar.

The loss (with the VLM's logits cut to the text) and its gradients, a
train step, the remat policies, the cache layouts and the analytic
parameter counts of the four families this slice added are held to the
reference too (``test_models.py``'s twins), and every arch's full-size
count and one reduced train step are the twins of
``test_full_size_param_counts`` and ``test_smoke_train_step``.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config import reduced_config as ref_reduced_config
from repro.config.types import RunConfig as RefRunConfig
from repro.config.types import ShapeConfig as RefShapeConfig
from repro.config.types import TrainConfig as RefTrainConfig
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models import rglru as ref_rglru
from repro.models import runtime_flags
from repro.models.lm import build_model as ref_build_model
from repro.models.param import count_tree_params as ref_count_tree_params
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.state import TrainState as RefTrainState
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.config import (Family, ParallelConfig, RunConfig,
                                ShapeConfig, TrainConfig, get_arch,
                                list_archs, reduced_config)
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models import layers as L
from repro_torch.models import lm as lm_mod
from repro_torch.models import rglru
from repro_torch.models.convert import _unstack, load_reference_params
from repro_torch.models.lm import build_model
from repro_torch.models.param import count_tree_params
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import AdamWConfig, TrainState, make_train_step
from repro_torch.utils.tree import tree_flatten_with_paths, tree_leaves

ARCHS = ["granite-3-2b", "internlm2-20b", "command-r-plus-104b",
         "h2o-danube-1.8b", "mamba2-370m",
         "recurrentgemma-2b", "paligemma-3b", "moonshot-v1-16b-a3b",
         "deepseek-v3-671b", "hubert-xlarge"]
# the families this slice added
NEW_ARCHS = ["mamba2-370m", "recurrentgemma-2b", "paligemma-3b",
             "hubert-xlarge"]
# (arch, depth): the reduced configs, and the 3-layer hybrid
CASES = [(n, None) for n in ARCHS] + [("recurrentgemma-2b", 3)]
DECODER_CASES = [c for c in CASES if get_arch(c[0]).decoder]
NEW_CASES = [c for c in CASES if c[0] in NEW_ARCHS]
B, S = 2, 16
ATOL = 5e-4
LOSS_REL, PARAM_ATOL = 1e-5, 1e-5  # tests/test_train.py:67-70
GRAD_REL = 1e-4                   # tests/test_torch_train.py


def _id(case):
    name, depth = case
    return name if depth is None else f"{name}-{depth}L"


def _as_dict(cfg):
    return {k: (v.value if hasattr(v, "value") else v)
            for k, v in dataclasses.asdict(cfg).items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jbatch(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


class _Pair:
    """The reference model with its params and the port's model loaded
    with the same weights."""

    def __init__(self, case, seed):
        name, depth = case
        self.case = case
        self.ref_cfg = ref_reduced_config(ref_get_arch(name))
        self.cfg = reduced_config(get_arch(name))
        if depth is not None:
            self.ref_cfg = dataclasses.replace(self.ref_cfg, n_layers=depth)
            self.cfg = dataclasses.replace(self.cfg, n_layers=depth)
        self.ref = ref_build_model(self.ref_cfg)
        self.params = self.ref.init(jax.random.PRNGKey(seed),
                                    dtype=jnp.float32)
        self.port = build_model(self.cfg, device="cpu", dtype=torch.float32)
        load_reference_params(self.port, _np(self.params))

    def ref_by_path(self, params):
        tree = dict(_np(params))
        tree["layers"] = _unstack(tree["layers"], self.cfg.n_layers)
        return dict(tree_flatten_with_paths(tree))


@pytest.fixture(scope="module", params=CASES, ids=_id)
def pair(request):
    return _Pair(request.param, 1)


@pytest.fixture(scope="module", params=DECODER_CASES, ids=_id)
def decoder_pair(request):
    return _Pair(request.param, 1)


def _tokens(cfg, seed=2, b=B, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s), dtype=np.int32)


def _batch(cfg, seed=2, b=B, s=S, labels=False):
    """A NumPy batch of the family's inputs: ``frames`` (audio), or
    ``tokens`` with ``patches`` before them (VLM); ``labels`` too when
    asked (for the VLM, one per text token)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == Family.AUDIO:
        out["frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    if cfg.family == Family.VLM:
        out["patches"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_arch_configs_match_reference():
    assert sorted(list_archs()) == sorted(ARCHS)
    for name in ARCHS:
        assert _as_dict(get_arch(name)) == _as_dict(ref_get_arch(name))
        assert _as_dict(reduced_config(get_arch(name))) == _as_dict(
            ref_reduced_config(ref_get_arch(name)))


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_param_count_matches_reference(name, full):
    """Twin of ``test_param_count_matches_analytic`` (reduced) and of the
    analytic counts at full width."""
    cfg = get_arch(name)
    ref_cfg = ref_get_arch(name)
    if not full:
        cfg, ref_cfg = reduced_config(cfg), ref_reduced_config(ref_cfg)
        specs = build_model(cfg, device="cpu",
                            dtype=torch.float32).param_specs()
        assert count_tree_params(specs) == cfg.param_count()
        assert cfg.param_count() == ref_count_tree_params(
            ref_build_model(ref_cfg).param_specs())
    assert cfg.param_count() == ref_cfg.param_count()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_forward_matches_reference(pair, backend, monkeypatch):
    monkeypatch.setattr(runtime_flags, "ATTN_BACKEND", backend)
    batch = _batch(pair.cfg)
    want, want_aux = pair.ref.forward(pair.params, _jbatch(batch))
    got, aux = pair.port.forward(_torch_batch(batch))
    prefix = pair.cfg.frontend_tokens if pair.cfg.family == Family.VLM else 0
    assert tuple(got.shape) == (B, prefix + S, pair.cfg.vocab_size)
    # 0 for the dense archs; the router's load-balancing loss for MoE
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    assert (float(aux) > 0.0) == (pair.cfg.moe is not None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(
        pair.port.prefill(_torch_batch(batch), 32).numpy(),
        np.asarray(want[:, -1]), atol=ATOL)


def test_decode_matches_forward_and_reference(decoder_pair):
    """Token-by-token decode reproduces the forward's logits and the
    reference's decode logits; with cache_len 16 the window-8 ring
    buffers (danube's, the hybrid's local attention) wrap after step 8.
    The VLM's forward runs with zero patches (decode embeds text only,
    as the reference's test runs it)."""
    pair = decoder_pair
    tokens = _tokens(pair.cfg, seed=3)
    batch = {"tokens": torch.from_numpy(tokens)}
    if pair.cfg.family == Family.VLM:
        batch["patches"] = torch.zeros((B, 0, pair.cfg.d_model))
    fwd, _ = pair.port.forward(batch)
    cache = pair.port.init_cache(B, cache_len=16, dtype=torch.float32)
    ref_cache = pair.ref.init_cache(B, cache_len=16, dtype=jnp.float32)
    window = pair.cfg.sliding_window or (
        pair.cfg.rglru.attn_window if pair.cfg.rglru else 0)
    for c, kind in zip(cache, pair.port.kinds):
        if "k" in c and window:
            assert c["k"].shape[2] == window < S, kind
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        got, cache = pair.port.decode_step(torch.from_numpy(tokens[:, t]),
                                           cache, torch.from_numpy(pos))
        want, ref_cache = pair.ref.decode_step(
            pair.params, jnp.asarray(tokens[:, t]), ref_cache,
            jnp.asarray(pos))
        np.testing.assert_allclose(got.numpy(), fwd[:, t].numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for c in cache:
        if "length" in c:
            assert c["length"].tolist() == [S] * B


@pytest.mark.parametrize("case", DECODER_CASES, ids=_id)
def test_serve_engine_matches_reference(case):
    """The reference test's requests (``tests/test_data_serve.py:55-65``):
    the port's engine gives the reference engine's greedy tokens."""
    p = _Pair(case, 0)
    prompts = [([1, 2, 3], 5), ([7, 8], 5)]
    want = RefServeEngine(p.ref, p.params, cache_len=64).generate(
        [RefRequest(prompt=pr, max_new_tokens=n) for pr, n in prompts])
    got = ServeEngine(p.port, cache_len=64).generate(
        [Request(prompt=pr, max_new_tokens=n) for pr, n in prompts])
    for g, w in zip(got, want):
        assert len(g.out_tokens) == 5
        assert all(0 <= t < p.cfg.vocab_size for t in g.out_tokens)
        assert g.out_tokens == w.out_tokens


def test_cpu_model_never_launches(pair):
    before = (dict(fa_kernel.launches), dict(dec_kernel.launches))
    if pair.cfg.decoder:
        ServeEngine(pair.port, cache_len=8).generate(
            [Request(prompt=[3, 4], max_new_tokens=2)])
    else:
        pair.port.forward(_torch_batch(_batch(pair.cfg)))
    assert (fa_kernel.launches, dec_kernel.launches) == before


def test_init_is_seeded_and_follows_the_reference_rules():
    cfg = reduced_config(get_arch("granite-3-2b"))

    def weights(seed):
        m = build_model(cfg, device="cpu", dtype=torch.float32)
        return m.init(torch.Generator().manual_seed(seed))

    a, b, c = weights(0), weights(0), weights(1)
    for (name, x), (_, y), (_, z) in zip(a.named_parameters(),
                                         b.named_parameters(),
                                         c.named_parameters()):
        assert torch.equal(x, y), name
        if "ln" in name or "norm" in name:
            assert torch.equal(x, torch.ones_like(x)), name
        else:
            assert not torch.equal(x, z), name
    wq = a.layers[0].attn["wq"]
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.1


# ------------------------------------- the SSM, hybrid, VLM, audio families
@pytest.fixture(scope="module", params=NEW_CASES, ids=_id)
def carried(request):
    return _Pair(request.param, 0)


def _grads(model, batch):
    """(loss, {path: gradient}) of ``model.loss`` on ``batch``."""
    model.requires_grad_(True)
    loss = model.loss(batch)
    leaves = tree_leaves(model.param_tree())
    paths = [p for p, _ in tree_flatten_with_paths(model.param_tree())]
    grads = dict(zip(paths, (g.detach().numpy() for g in
                             torch.autograd.grad(loss, leaves,
                                                 materialize_grads=True))))
    model.requires_grad_(False)
    return float(loss.detach()), grads


# the stacked 2-layer hybrid: its float32 gradients are ill-conditioned
HYBRID_2L = ("recurrentgemma-2b", None)


def _grads64(c, batch, monkeypatch):
    """(reference's, port's) {path: gradient} of the same weights and
    batch in float64: params widened, and every float32 cast the 2-layer
    hybrid (no attention block) makes patched to float64 in both
    packages: ``layers.F32`` (the norms), ``rglru.F32`` (the gates) and
    the cross-entropy's ``_xent``."""
    def ref_xent(logits, labels):
        lp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(lp, labels[..., None],
                                             axis=-1)[..., 0])

    def port_xent(logits, labels):
        lp = torch.log_softmax(logits, dim=-1)
        return -torch.take_along_dim(lp, labels.long()[..., None],
                                     dim=-1).mean()

    with monkeypatch.context() as mp:
        for mod in (ref_layers, ref_rglru):
            mp.setattr(mod, "F32", jnp.float64)
        for mod in (L, rglru):
            mp.setattr(mod, "F32", torch.float64)
        mp.setattr(ref_lm, "_xent", ref_xent)
        mp.setattr(lm_mod, "_xent", port_xent)
        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a, np.float64)), c.params)
            ref = c.ref_by_path(jax.grad(
                lambda p: c.ref.loss(p, _jbatch(batch)))(p64))
        _, port = _grads(copy.deepcopy(c.port).to(torch.float64), batch)
    return ref, port


def _grad_bars(c, batch, want, monkeypatch):
    """{path: bar} for a float32 gradient against the reference's
    ``want``: ``1e-5`` plus ``1e-4`` of the leaf's largest element. For
    the stacked 2-layer hybrid the ``1e-4`` grows by twice the
    reference's own float32 error: the largest distance, over all its
    leaves, of ``want`` from the reference's float64 gradient, as a share
    of that leaf's largest element. Read from the reference alone."""
    share = 0.0
    if c.case == HYBRID_2L:
        ref64, _ = _grads64(c, batch, monkeypatch)
        share = max(np.abs(want[p] - ref64[p]).max()
                    / np.abs(ref64[p]).max() for p in want)
    return {p: PARAM_ATOL + (GRAD_REL + 2 * share) * np.abs(want[p]).max()
            for p in want}


def test_loss_and_grads_match_reference(carried, monkeypatch):
    """Cross-entropy (the VLM's over its text positions only) at
    ``rel=1e-5``; each gradient within ``1e-5`` plus ``1e-4`` of its
    largest element of the reference's (float32's bar, as for MoE,
    ``tests/test_torch_train.py``).

    The stacked 2-layer hybrid alone has a wider float32 bar
    (``_grad_bars``): the reference's fan-in rule saturates its
    recurrence gates (``1 - a²`` cancels), so the reference's float32
    gradients lie up to 2.0e-3 of a leaf's largest element from its
    float64 gradient, the port's up to 2.0e-3 too (3.7x the reference's
    on single leaves, ``layers/0/rec/ba``), and the two packages' 1.5e-3
    from each other. The widening is read from the reference, never from
    the port. There the port's float64 gradient is held to the
    reference's float64 gradient, leaf by leaf, at ``1e-8`` of the leaf's
    largest element (2.2e-10 measured): the arithmetic is the
    reference's, float32 aside."""
    c = carried
    batch = _batch(c.cfg, seed=11, b=4, labels=True)
    loss, grads = _grads(c.port, batch)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: c.ref.loss(p, _jbatch(batch)))(c.params)
    assert np.isfinite(loss)
    assert loss == pytest.approx(float(ref_loss), rel=LOSS_REL)
    want = c.ref_by_path(ref_grads)
    assert set(grads) == set(want)
    bars = _grad_bars(c, batch, want, monkeypatch)
    for path, g in grads.items():
        err = np.abs(g - want[path]).max()
        assert err <= bars[path], (path, err, bars[path])
    if c.case == HYBRID_2L:
        ref64, port64 = _grads64(c, batch, monkeypatch)
        assert set(port64) == set(ref64)
        for path, g in port64.items():
            err = np.abs(g - ref64[path]).max()
            assert err <= 1e-8 * np.abs(ref64[path]).max(), (path, err)


def test_train_step_matches_reference(carried, monkeypatch):
    """One ``make_train_step`` step (remat ``"dots"``) from the carried
    weights against the reference's ``jit``ted step, with no warm-up so
    that the step's lr is not 0: loss, grad norm, then every parameter,
    which must have moved by more than 10x the parameters' ``atol``
    (twin of ``test_smoke_train_step``).

    Each parameter is held at ``atol=1e-5`` plus what the gradient's bar
    (``_grad_bars``, after the clip) can move AdamW's first step,
    ``lr * g / (|g| + eps)``, at that element of the reference's
    gradient ``g``. Where ``|g|`` is well above the bar and ``eps`` that
    slack is far below ``atol``; where ``|g|`` is within the bar of 0 (an attention key
    bias, whose gradient is 0 up to rounding), the step's sign is
    float32 noise in both packages and the slack reaches ``2 * lr``."""
    c = carried
    batch = _batch(c.cfg, seed=12, b=4, labels=True)
    train = TrainConfig(warmup_steps=0)
    run = RunConfig(arch=c.cfg, shape=ShapeConfig("t", S, 4, "train"),
                    train=train)
    ref_run = RefRunConfig(arch=c.ref_cfg,
                           shape=RefShapeConfig("t", S, 4, "train"),
                           train=RefTrainConfig(warmup_steps=0))
    state, m = make_train_step(c.port, run)(
        TrainState.init(c.port.param_tree(), AdamWConfig()), batch)
    ref_state, rm = jax.jit(ref_make_train_step(c.ref, ref_run))(
        RefTrainState.init(c.params, RefAdamWConfig()), _jbatch(batch))
    assert np.isfinite(float(m["loss"])) and int(state["step"]) == 1
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                             rel=LOSS_REL)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=GRAD_REL)
    lr = float(rm["lr"])
    assert lr == pytest.approx(train.learning_rate)
    grad = c.ref_by_path(jax.grad(
        lambda p: c.ref.loss(p, _jbatch(batch)))(c.params))
    bars = _grad_bars(c, batch, grad, monkeypatch)
    clip = min(1.0, train.grad_clip / float(rm["grad_norm"]))

    def first_step(g):
        return g / (np.abs(g) + train.eps)

    want = c.ref_by_path(ref_state["params"])
    start = c.ref_by_path(c.params)
    moved = 0.0
    for path, t in tree_flatten_with_paths(state["params"]):
        g = clip * grad[path].astype(np.float64)
        d = clip * bars[path]
        slack = lr * np.maximum(first_step(g + d) - first_step(g),
                                first_step(g) - first_step(g - d))
        err = np.abs(t.detach().numpy() - want[path])
        assert np.all(err <= PARAM_ATOL + slack), (
            path, err.max(), (err - slack).max())
        moved = max(moved, np.abs(want[path] - start[path]).max())
    assert moved > 10 * PARAM_ATOL, moved
    c.port.requires_grad_(False)
    load_reference_params(c.port, _np(c.params))


@pytest.mark.parametrize("case", NEW_CASES, ids=_id)
def test_remat_applies_to_every_block_kind(case):
    """Losses and gradients equal with ``==`` under ``none``, ``dots``
    and ``full``, for the SSM, RG-LRU and local-attention blocks and the
    frontends."""
    cfg = reduced_config(get_arch(case[0]))
    if case[1] is not None:
        cfg = dataclasses.replace(cfg, n_layers=case[1])
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(5)).requires_grad_(True)
    batch = _batch(cfg, seed=2, labels=True)
    leaves = tree_leaves(model.param_tree())
    out = {}
    for remat in ("none", "dots", "full"):
        loss = model.loss(batch, remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(
            loss, leaves, materialize_grads=True))
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for g, g0 in zip(out[remat][1], out["none"][1]):
            assert torch.equal(g, g0), remat


def test_ssm_cache_is_constant_size():
    """Twin of ``test_ssm_cache_is_constant_size``: the layout, shapes
    and dtypes are the reference's, at every cache length."""
    cfg = reduced_config(get_arch("mamba2-370m"))
    ref = ref_build_model(ref_reduced_config(ref_get_arch("mamba2-370m")))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    shapes = [[(k, tuple(s.shape)) for k, s in layer.items()]
              for layer in model.cache_spec(batch=1, cache_len=100)]
    assert shapes == [[(k, tuple(s.shape)) for k, s in layer.items()]
                      for layer in model.cache_spec(batch=1,
                                                    cache_len=100000)]
    want = ref.cache_spec(batch=1, cache_len=100)      # stacked layers
    for layer in shapes:
        assert layer == [(k, tuple(want[k].shape[1:])) for k, _ in layer]


def test_hybrid_local_attention_cache_is_bounded():
    """The hybrid's local-attention blocks keep a ring buffer of
    ``min(cache_len, attn_window)`` positions (the twin of
    ``test_sliding_window_cache_is_bounded``); its recurrent blocks'
    states are constant-size. Layouts as the reference's list."""
    name = "recurrentgemma-2b"
    cfg = dataclasses.replace(reduced_config(get_arch(name)), n_layers=3)
    ref = ref_build_model(dataclasses.replace(
        ref_reduced_config(ref_get_arch(name)), n_layers=3))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    assert model.kinds == ("rec", "rec", "attn_local")
    for cache_len, eff in ((1000, cfg.rglru.attn_window), (5, 5)):
        got = model.cache_spec(batch=1, cache_len=cache_len)
        want = ref.cache_spec(batch=1, cache_len=cache_len)
        assert [{k: tuple(s.shape) for k, s in layer.items()}
                for layer in got] == [
            {k: tuple(s.shape) for k, s in layer.items()} for layer in want]
        assert got[2]["k"].shape[2] == eff
        assert got[0]["h"].shape == (1, cfg.rglru.lru_width)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_full_width_reference_params_load(name):
    """``load_reference_params`` takes the reference's full-width param
    tree (its ``abstract_params``, as zero-stride arrays) into the port's
    full-width model on the ``meta`` device: every key and shape
    matches, stacked (mamba2, hubert) or listed (the hybrid)."""
    ref = ref_build_model(ref_get_arch(name))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        ref.abstract_params())
    model = build_model(get_arch(name), device="meta", dtype=torch.bfloat16)
    load_reference_params(model, zeros)
    assert (sum(p.numel() for p in model.parameters())
            == get_arch(name).param_count())


def test_full_size_param_counts():
    """Twin of ``tests/test_models.py::test_full_size_param_counts``:
    analytic counts in the advertised ballpark, and the full-size spec
    tree (``abstract_params``, on the meta device) counts the same."""
    targets = {
        "command-r-plus-104b": (95e9, 115e9),
        "deepseek-v3-671b": (620e9, 760e9),
        "granite-3-2b": (2.2e9, 2.8e9),
        "internlm2-20b": (18e9, 22e9),
        "mamba2-370m": (0.3e9, 0.45e9),
        "hubert-xlarge": (0.8e9, 1.1e9),
    }
    for name, (lo, hi) in targets.items():
        n = get_arch(name).param_count()
        assert lo <= n <= hi, f"{name}: {n/1e9:.1f}B outside [{lo/1e9},{hi/1e9}]"
        model = build_model(get_arch(name), device="meta")
        assert sum(t.numel() for t in tree_leaves(
            model.abstract_params())) == n


@pytest.mark.parametrize("name", ARCHS)
def test_smoke_train_step(name):
    """Twin of ``tests/test_models.py::test_smoke_train_step``: reduced
    config, one train step on the CPU, finite loss and grad norm."""
    cfg = reduced_config(get_arch(name))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", S, B, "train"),
                    parallel=ParallelConfig(remat="none",
                                            opt_state_dtype="float32"))
    state = TrainState.init(model.param_tree(), AdamWConfig())
    state, metrics = make_train_step(model, run)(
        state, _batch(cfg, labels=True))
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert int(state["step"]) == 1
