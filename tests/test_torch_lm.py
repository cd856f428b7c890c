"""CPU parity of the port's LM serving path with the reference's.

At ``reduced_config`` of granite-3-2b (full causal attention),
h2o-danube-1.8b (sliding window 8, untied head), moonshot-v1-16b-a3b
(MoE, 4 experts top-2) and deepseek-v3-671b (MLA, MoE with a shared
expert, the MTP head), the reference's weights
(``repro``'s ``model.init(PRNGKey(1), dtype=float32)``) go through
``load_reference_params`` into the port. Then the forward logits, the
step-by-step decode logits (danube's ring buffer wraps) and the serving
engine's greedy tokens must match the reference's, at the decode tests'
``atol=5e-4`` (``tests/test_models.py:99``). The reference's forward runs
once through its Pallas kernels too (``runtime_flags.ATTN_BACKEND``
patched to ``"pallas"``), so the slice is held against both. The MoE
archs' router aux loss is held to the reference's at ``rel=1e-6``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config import reduced_config as ref_reduced_config
from repro.models import runtime_flags
from repro.models.lm import build_model as ref_build_model
from repro.models.param import count_tree_params as ref_count_tree_params
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.config import (ArchConfig, AttentionKind, Family,
                                RGLRUConfig, SSMConfig, get_arch,
                                list_archs, reduced_config)
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models.convert import load_reference_params
from repro_torch.models.lm import build_model
from repro_torch.models.param import count_tree_params
from repro_torch.serve import Request, ServeEngine

ARCHS = ["granite-3-2b", "h2o-danube-1.8b", "moonshot-v1-16b-a3b",
         "deepseek-v3-671b"]
B, S = 2, 16
ATOL = 5e-4


def _as_dict(cfg):
    return {k: (v.value if hasattr(v, "value") else v)
            for k, v in dataclasses.asdict(cfg).items()}


class _Pair:
    """The reference model with its params and the port's model loaded
    with the same weights."""

    def __init__(self, name, seed):
        self.ref_cfg = ref_reduced_config(ref_get_arch(name))
        self.cfg = reduced_config(get_arch(name))
        self.ref = ref_build_model(self.ref_cfg)
        self.params = self.ref.init(jax.random.PRNGKey(seed),
                                    dtype=jnp.float32)
        self.port = build_model(self.cfg, device="cpu", dtype=torch.float32)
        load_reference_params(
            self.port, jax.tree_util.tree_map(np.asarray, self.params))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _Pair(request.param, 1)


def _tokens(cfg, seed=2, b=B, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s), dtype=np.int32)


def test_arch_configs_match_reference():
    assert sorted(list_archs()) == sorted(ARCHS)
    for name in ARCHS:
        assert _as_dict(get_arch(name)) == _as_dict(ref_get_arch(name))
        assert _as_dict(reduced_config(get_arch(name))) == _as_dict(
            ref_reduced_config(ref_get_arch(name)))


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_param_count_matches_reference(name, full):
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
    tokens = _tokens(pair.cfg)
    want, want_aux = pair.ref.forward(pair.params,
                                      {"tokens": jnp.asarray(tokens)})
    got, aux = pair.port.forward({"tokens": torch.from_numpy(tokens)})
    assert tuple(got.shape) == (B, S, pair.cfg.vocab_size)
    # 0 for the dense archs; the router's load-balancing loss for MoE
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    assert (float(aux) > 0.0) == (pair.cfg.moe is not None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(
        pair.port.prefill({"tokens": torch.from_numpy(tokens)}, 32).numpy(),
        np.asarray(want[:, -1]), atol=ATOL)


def test_decode_matches_forward_and_reference(pair):
    """Token-by-token decode reproduces the forward's logits and the
    reference's decode logits; with cache_len 16 danube's window-8 ring
    buffer wraps after step 8."""
    tokens = _tokens(pair.cfg, seed=3)
    fwd, _ = pair.port.forward({"tokens": torch.from_numpy(tokens)})
    cache = pair.port.init_cache(B, cache_len=16, dtype=torch.float32)
    ref_cache = pair.ref.init_cache(B, cache_len=16, dtype=jnp.float32)
    if pair.cfg.sliding_window:
        assert cache[0]["k"].shape[2] == pair.cfg.sliding_window < S
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
    assert cache[0]["length"].tolist() == [S] * B


@pytest.mark.parametrize("name", ARCHS)
def test_serve_engine_matches_reference(name):
    """The reference test's requests (``tests/test_data_serve.py:55-65``):
    the port's engine gives the reference engine's greedy tokens."""
    p = _Pair(name, 0)
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
    ServeEngine(pair.port, cache_len=8).generate(
        [Request(prompt=[3, 4], max_new_tokens=2)])
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


def test_unported_families_raise():
    ssm = ArchConfig(name="ssm", family=Family.SSM, n_layers=1, d_model=32,
                     n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=16,
                     attention=AttentionKind.NONE,
                     ssm=SSMConfig(state_dim=8, head_dim=8))
    with pytest.raises(NotImplementedError, match="ssm"):
        build_model(ssm, device="cpu")
    hybrid = ArchConfig(name="hybrid", family=Family.HYBRID, n_layers=3,
                        d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                        vocab_size=16, attention=AttentionKind.SLIDING,
                        sliding_window=8,
                        rglru=RGLRUConfig(lru_width=32, attn_window=8))
    with pytest.raises(NotImplementedError, match="hybrid"):
        build_model(hybrid, device="cpu")
