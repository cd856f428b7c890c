"""CPU parity of the port's Mamba-2 SSD layer (``repro_torch/models/
ssm.py``) with the reference's (``repro/models/ssm.py``).

Inputs are made with NumPy from a seed and handed to both packages. The
layer is jnp/XLA in the reference (no Pallas kernel), torch ops in the
port; both compute in float32 with sums in their own orders, so each
comparison states its tolerance:

* ``_segsum``: the finite entries at ``4e-6``, four float32 ulps of the
  cumsums they are differences of (below 16; XLA's cumsum adds in
  another order), the ``-inf`` pattern ``==``;
* ``ssd_chunked`` (four chunks, one chunk, and chunk 1), ``ssm_apply``
  and ``ssm_decode``: ``atol=1e-5`` on outputs of magnitude ~1-10 (about
  8 float32 ulps at 10), the decode tests' ``5e-4``
  (``tests/test_models.py:99``) being the bar the model is held to;
* the causal conv in the model's dtype ``==`` (the port spells out the
  reference's sum and order); softplus (``logaddexp(x, 0)``, as
  ``jax.nn.softplus``, also above 20) at ``rtol=2.5e-7``, two float32
  ulps (the two libraries' ``log1p``/``exp`` round differently).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config import reduced_config as ref_reduced_config
from repro.models import ssm as ref_ssm
from repro.models.param import materialize as ref_materialize
from repro_torch.config import get_arch, reduced_config
from repro_torch.models import ssm

ATOL = 1e-5


def _cfgs(**ssm_kw):
    cfg = reduced_config(get_arch("mamba2-370m"))
    ref_cfg = ref_reduced_config(ref_get_arch("mamba2-370m"))
    if ssm_kw:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               **ssm_kw))
        ref_cfg = dataclasses.replace(
            ref_cfg, ssm=dataclasses.replace(ref_cfg.ssm, **ssm_kw))
    return cfg, ref_cfg


def _params(ref_cfg, seed=0):
    """The reference's float32 layer params, perturbed from their
    constant inits so that every term is exercised, as numpy and as
    torch."""
    params = ref_materialize(ref_ssm.ssm_spec(ref_cfg),
                             jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        a = np.array(v)
        if k in ("A_log", "D", "dt_bias", "conv_b", "norm_scale"):
            a = a + 0.3 * rng.standard_normal(a.shape).astype(np.float32)
        out[k] = a
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _ssd_inputs(b, s, h, p, n, seed=1):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = -rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return xdt, a, B, C


def test_segsum_matches_reference():
    a = -np.random.default_rng(0).uniform(0, 1, (2, 3, 4, 16)).astype(
        np.float32)
    want = np.asarray(ref_ssm._segsum(jnp.asarray(a)))
    got = ssm._segsum(torch.from_numpy(a)).numpy()
    assert got.shape == want.shape == (2, 3, 4, 16, 16)
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    assert np.all(want[~finite] == -np.inf)
    assert np.all(got[~finite] == -np.inf)
    np.testing.assert_allclose(got[finite], want[finite], atol=4e-6)


@pytest.mark.parametrize("s,chunk", [(32, 8), (16, 16), (12, 1)])
def test_ssd_chunked_matches_reference(s, chunk):
    """Several chunks, one chunk, and the ``chunk = 1`` path (one
    position a chunk: the recurrence alone)."""
    xdt, a, B, C = _ssd_inputs(2, s, 3, 4, 8)
    y_ref, st_ref = ref_ssm.ssd_chunked(jnp.asarray(xdt), jnp.asarray(a),
                                        jnp.asarray(B), jnp.asarray(C),
                                        chunk)
    y, st = ssm.ssd_chunked(torch.from_numpy(xdt), torch.from_numpy(a),
                            torch.from_numpy(B), torch.from_numpy(C), chunk)
    assert y.dtype == st.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), atol=ATOL)


def test_ssd_chunked_is_the_recurrence():
    """The block decomposition equals the plain per-position recurrence
    h_t = exp(a_t) h_{t-1} + x_t B_tᵀ, y_t = h_t C_t (float64 loop)."""
    xdt, a, B, C = _ssd_inputs(1, 24, 2, 3, 5, seed=4)
    y, st = ssm.ssd_chunked(torch.from_numpy(xdt), torch.from_numpy(a),
                            torch.from_numpy(B), torch.from_numpy(C), 8)
    h = np.zeros((1, 2, 3, 5))
    ys = []
    for t in range(24):
        h = (h * np.exp(a[:, t].astype(np.float64))[..., None, None]
             + xdt[:, t, :, :, None] * B[:, t, None, None, :])
        ys.append(np.einsum("bhpn,bn->bhp", h, C[:, t]))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), atol=ATOL)
    np.testing.assert_allclose(st.numpy(), h, atol=ATOL)


def test_ssd_chunked_rejects_a_ragged_chunk():
    xdt, a, B, C = (torch.from_numpy(t) for t in _ssd_inputs(1, 12, 2, 3, 4))
    with pytest.raises(ValueError, match="multiple"):
        ssm.ssd_chunked(xdt, a, B, C, 8)


def test_softplus_and_conv_are_the_references():
    x = np.concatenate([np.linspace(-40, 40, 161),
                        [0.0, 19.9, 20.1, 25.0, 88.0]]).astype(np.float32)
    np.testing.assert_allclose(
        ssm.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2.5e-7, atol=0)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    pad = jnp.pad(jnp.asarray(xs), ((0, 0), (3, 0), (0, 0)))
    want = sum(pad[:, i:i + 9, :] * jnp.asarray(w)[i] for i in range(4))
    np.testing.assert_array_equal(
        ssm.causal_conv(torch.from_numpy(xs), torch.from_numpy(w)).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("s", [16, 20])
def test_ssm_apply_matches_reference(s):
    """s 16 runs two chunks of 8; s 20 is no multiple of the chunk, so
    both take the reference's ``chunk = 1`` rule."""
    cfg, ref_cfg = _cfgs()
    ref_p, p = _params(ref_cfg)
    x = np.random.default_rng(5).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref_ssm.ssm_apply(ref_p, ref_cfg, jnp.asarray(x)))
    got = ssm.ssm_apply(p, cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_ssm_decode_matches_reference_and_apply():
    """Step by step from a zero cache: each output against the
    reference's step and the port's full pass; the cache's state against
    the reference's; the cache tensors are written in place."""
    cfg, ref_cfg = _cfgs()
    ref_p, p = _params(ref_cfg, seed=2)
    b, s = 2, 16
    x = np.random.default_rng(6).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    full = ssm.ssm_apply(p, cfg, torch.from_numpy(x))
    specs = ssm.ssm_cache_spec(cfg, b, dtype=torch.float32)
    cache = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
             specs.items()}
    addrs = {k: t.data_ptr() for k, t in cache.items()}
    ref_cache = jax.tree_util.tree_map(
        lambda sd: jnp.zeros(sd.shape, sd.dtype),
        ref_ssm.ssm_cache_spec(ref_cfg, b, dtype=jnp.float32))
    for t in range(s):
        y, cache = ssm.ssm_decode(p, cfg, torch.from_numpy(x[:, t:t + 1]),
                                  cache)
        want, ref_cache = ref_ssm.ssm_decode(ref_p, ref_cfg,
                                             jnp.asarray(x[:, t:t + 1]),
                                             ref_cache)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, t].numpy(),
                                   atol=ATOL)
    assert {k: t.data_ptr() for k, t in cache.items()} == addrs
    for k in ("state", "conv"):
        np.testing.assert_allclose(cache[k].numpy(),
                                   np.asarray(ref_cache[k]), atol=ATOL)


def test_cache_spec_is_the_references():
    cfg, ref_cfg = _cfgs()
    got = ssm.ssm_cache_spec(cfg, 3, dtype=torch.bfloat16)
    want = ref_ssm.ssm_cache_spec(ref_cfg, 3, dtype=jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
