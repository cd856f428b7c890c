"""CPU parity of the port's RG-LRU block (``repro_torch/models/rglru.py``)
with the reference's (``repro/models/rglru.py``).

Inputs are made with NumPy from a seed and handed to both packages.

* :func:`associative_scan` is a copy of the recursion of
  ``jax.lax.associative_scan``: with the RG-LRU's combine it gives the
  reference's (eager) scan ``==`` (the same products and sums in the
  same order) at every length from 1 to 33 and at 2048, and stays within
  ``1e-5`` of the sequential recurrence in float64. The running product
  of the decays is ``==`` too, down to float32's smallest normal number:
  below it XLA on the CPU flushes a product to zero and torch keeps the
  subnormal (the block uses only the scanned state).
* ``_gates``, ``rglru_apply`` and ``rglru_decode`` (step by step, against
  the reference's steps and against the port's full pass) at
  ``atol=1e-5`` on outputs of magnitude ~1-5: float32 matrix products
  add in each library's own order; the decode tests' ``5e-4``
  (``tests/test_models.py:99``) is the bar the model is held to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config import reduced_config as ref_reduced_config
from repro.models import rglru as ref_rglru
from repro.models.param import materialize as ref_materialize
from repro_torch.config import get_arch, reduced_config
from repro_torch.models import rglru

ATOL = 1e-5


def _cfgs():
    return (reduced_config(get_arch("recurrentgemma-2b")),
            ref_reduced_config(ref_get_arch("recurrentgemma-2b")))


def _params(ref_cfg, seed=0):
    """The reference's float32 block params, the biases and ``lam``
    perturbed from their constant inits, as jnp and as torch."""
    params = ref_materialize(ref_rglru.rglru_spec(ref_cfg),
                             jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        a = np.array(v)
        if k in ("conv_b", "ba", "bx", "lam"):
            a = a + 0.5 * rng.standard_normal(a.shape).astype(np.float32)
        out[k] = a
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _ref_combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _scan_inputs(n, seed=0, w=5):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 0.999, (2, n, w)).astype(np.float32)
    b = rng.standard_normal((2, n, w)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("n", list(range(1, 34)) + [2048])
def test_associative_scan_is_jaxs(n):
    a, b = _scan_inputs(n, seed=n)
    want = jax.lax.associative_scan(_ref_combine,
                                    (jnp.asarray(a), jnp.asarray(b)), axis=1)
    prod, h = rglru.associative_scan(
        rglru._combine, (torch.from_numpy(a), torch.from_numpy(b)), axis=1)
    np.testing.assert_array_equal(h.numpy(), np.asarray(want[1]))
    tiny = np.finfo(np.float32).tiny
    prod, want_prod = prod.numpy(), np.asarray(want[0])
    normal = np.abs(prod) >= tiny
    np.testing.assert_array_equal(prod[normal], want_prod[normal])
    assert np.all(np.abs(want_prod[~normal]) < tiny)


def test_associative_scan_is_the_recurrence():
    a, b = _scan_inputs(300, seed=1)
    _, h = rglru.associative_scan(rglru._combine, (torch.from_numpy(a),
                                                   torch.from_numpy(b)), 1)
    want = np.zeros((2, 5))
    for t in range(300):
        want = a[:, t].astype(np.float64) * want + b[:, t]
        np.testing.assert_allclose(h[:, t].numpy(), want, atol=ATOL)


def test_associative_scan_on_another_axis():
    a, b = _scan_inputs(7, seed=2)
    a, b = a.transpose(1, 0, 2).copy(), b.transpose(1, 0, 2).copy()
    want = jax.lax.associative_scan(_ref_combine,
                                    (jnp.asarray(a), jnp.asarray(b)), axis=0)
    got = rglru.associative_scan(rglru._combine,
                                 (torch.from_numpy(a), torch.from_numpy(b)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gates_match_reference():
    cfg, ref_cfg = _cfgs()
    ref_p, p = _params(ref_cfg)
    x = np.random.default_rng(3).standard_normal(
        (2, 7, cfg.rglru.lru_width)).astype(np.float32)
    want = ref_rglru._gates(ref_p, jnp.asarray(x))
    got = rglru._gates(p, torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("s", [1, 16, 37])
def test_rglru_apply_matches_reference(s):
    cfg, ref_cfg = _cfgs()
    ref_p, p = _params(ref_cfg)
    x = np.random.default_rng(4).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref_rglru.rglru_apply(ref_p, ref_cfg, jnp.asarray(x)))
    got = rglru.rglru_apply(p, cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_rglru_decode_matches_reference_and_apply():
    """Step by step from a zero cache: each output against the
    reference's step and the port's full pass, the cache's ``h`` and
    conv history against the reference's; the cache tensors are written
    in place."""
    cfg, ref_cfg = _cfgs()
    ref_p, p = _params(ref_cfg, seed=1)
    b, s = 2, 16
    x = np.random.default_rng(5).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    full = rglru.rglru_apply(p, cfg, torch.from_numpy(x))
    specs = rglru.rglru_cache_spec(cfg, b, dtype=torch.float32)
    cache = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
             specs.items()}
    addrs = {k: t.data_ptr() for k, t in cache.items()}
    ref_cache = jax.tree_util.tree_map(
        lambda sd: jnp.zeros(sd.shape, sd.dtype),
        ref_rglru.rglru_cache_spec(ref_cfg, b, dtype=jnp.float32))
    for t in range(s):
        y, cache = rglru.rglru_decode(p, cfg,
                                      torch.from_numpy(x[:, t:t + 1]), cache)
        want, ref_cache = ref_rglru.rglru_decode(
            ref_p, ref_cfg, jnp.asarray(x[:, t:t + 1]), ref_cache)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, t].numpy(),
                                   atol=ATOL)
    assert {k: t.data_ptr() for k, t in cache.items()} == addrs
    for k in ("h", "conv"):
        np.testing.assert_allclose(cache[k].numpy(),
                                   np.asarray(ref_cache[k]), atol=ATOL)


def test_cache_spec_is_the_references():
    cfg, ref_cfg = _cfgs()
    got = rglru.rglru_cache_spec(cfg, 3, dtype=torch.bfloat16)
    want = ref_rglru.rglru_cache_spec(ref_cfg, 3, dtype=jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
