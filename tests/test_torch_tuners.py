"""The port's Algorithm 1 (RPC tuner) and Algorithm 2 (cache tuner),
twinned with ``tests/test_tuners.py``."""
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core.cache_tuner import CacheDemand, cache_allocation
from repro_torch.core.policy import CaratSpaces, default_spaces
from repro_torch.core.rpc_tuner import (ConditionalScoreGreedy,
                                        EpsilonGreedyTuner, GreedyTuner,
                                        make_tuner)
from repro_torch.utils.rng import RngStream

SPACES = default_spaces()
FEAT = np.zeros(20, dtype=np.float32)


@pytest.fixture(scope="module", autouse=True)
def _jax_x64_off_after():
    """The reference's ``soa-jax`` backend turns JAX's float64 mode on for
    its whole process, and its tests leave it on. A test worker runs other
    files after this one, and the reference's nets (``tests/test_ml.py``)
    need JAX's default, so put it back when this module ends."""
    yield
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update("jax_enable_x64", False)


def _tuner(cls_kind, probs_by_candidate, **kw):
    """Build a tuner whose model returns fixed per-candidate probs."""
    probs = np.asarray(probs_by_candidate, dtype=np.float64)

    def model(X):
        return probs

    return make_tuner(cls_kind, SPACES, {"read": model, "write": model},
                      rng=RngStream(0, "t"), **kw)


def test_greedy_picks_argmax():
    n = len(SPACES.rpc_candidates())
    probs = np.zeros(n)
    probs[5] = 0.9
    t = _tuner("greedy", probs)
    assert t.propose("read", FEAT) == SPACES.rpc_candidates()[5]


def test_conditional_score_returns_none_below_tau():
    """Stability gate: no candidate above tau => retain current config."""
    n = len(SPACES.rpc_candidates())
    t = _tuner("conditional_score", np.full(n, 0.5), tau=0.8)
    assert t.propose("read", FEAT) is None


def test_conditional_score_prefers_progressive_write():
    """WriteScore biases toward larger theta among all-confident options."""
    n = len(SPACES.rpc_candidates())
    t = _tuner("conditional_score", np.full(n, 0.95), tau=0.8,
               alpha=0.5, beta=0.5)
    w, f = t.propose("write", FEAT)
    assert w == max(SPACES.rpc_window_pages)
    assert f == max(SPACES.rpcs_in_flight)


def test_conditional_score_read_formula():
    """ReadScore = f*(1+alpha*t1) + t2 — hand-check a 2-candidate case."""
    cands = SPACES.rpc_candidates()
    probs = np.zeros(len(cands))
    # candidate A: small window, max flight, p=0.85
    ia = cands.index((16, 256))
    # candidate B: max window, min flight, p=0.99
    ib = cands.index((1024, 1))
    probs[ia], probs[ib] = 0.85, 0.99
    t = _tuner("conditional_score", probs, tau=0.8, alpha=0.5, beta=0.5)
    # normalized over S={A,B}: A=(0,1), B=(1,0)
    score_a = 0.85 * (1 + 0.5 * 0.0) + 1.0     # = 1.85
    score_b = 0.99 * (1 + 0.5 * 1.0) + 0.0     # = 1.485
    assert score_a > score_b
    assert t.propose("read", FEAT) == (16, 256)


def test_epsilon_greedy_explores():
    n = len(SPACES.rpc_candidates())
    probs = np.zeros(n)
    probs[0] = 1.0
    t = _tuner("epsilon_greedy", probs, epsilon=0.5)
    picks = {t.propose("read", FEAT) for _ in range(50)}
    assert len(picks) > 1          # exploration happened
    assert SPACES.rpc_candidates()[0] in picks


# ------------------------------------------------------------- Algorithm 2
def test_cache_idle_clients_get_min():
    d = [CacheDemand(0, False, 0, 0, 0.0),
         CacheDemand(1, True, 100 * 2**20, 0, 1.0)]
    out = cache_allocation(d, SPACES, node_budget_mb=4096)
    assert out[0] == SPACES.cache_min


def test_cache_all_active_get_max_when_budget_allows():
    d = [CacheDemand(i, True, 10 * 2**20, 0, 0.5) for i in range(2)]
    out = cache_allocation(d, SPACES, node_budget_mb=10 * SPACES.cache_max)
    assert all(v == SPACES.cache_max for v in out.values())


def test_cache_constrained_uses_three_factors_snapped_up():
    d = [
        CacheDemand(0, True, peak_cache_bytes=300 * 2**20,
                    peak_inflight_bytes=0, write_rpc_share=0.0),
        CacheDemand(1, True, peak_cache_bytes=0,
                    peak_inflight_bytes=700 * 2**20, write_rpc_share=0.0),
    ]
    out = cache_allocation(d, SPACES, node_budget_mb=1024)
    assert out[0] == SPACES.snap_cache_up(300)      # 512
    assert out[1] == SPACES.snap_cache_up(700)      # 1024


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.booleans(), st.floats(0, 4e9),
                          st.floats(0, 4e9), st.floats(0, 1)),
                min_size=1, max_size=6))
def test_cache_allocation_always_on_grid(rows):
    demands = [CacheDemand(i, a, pc, pi, w)
               for i, (a, pc, pi, w) in enumerate(rows)]
    out = cache_allocation(demands, SPACES, node_budget_mb=4096)
    for cid, mb in out.items():
        assert mb in SPACES.dirty_cache_mb


def test_cache_budget_exhausted_by_idle_minimums():
    """Idle minimums above the node budget must not push `remaining`
    negative (the factor-(3) demands were going negative); active clients
    degrade to the grid floor instead."""
    d = [CacheDemand(i, False, 0.0, 0.0, 0.0) for i in range(3)]
    d.append(CacheDemand(3, True, 10 * 2**20, 0.0, 1.0))
    out = cache_allocation(d, SPACES, node_budget_mb=SPACES.cache_min * 2)
    assert out[3] == SPACES.cache_min
    for i in range(3):
        assert out[i] == SPACES.cache_min


@settings(max_examples=30, deadline=None)
@given(budget=st.floats(0, 512),
       rows=st.lists(st.tuples(st.booleans(), st.floats(0, 4e9),
                               st.floats(0, 4e9), st.floats(0, 1)),
                     min_size=1, max_size=6))
def test_cache_allocation_tight_budgets_stay_on_grid(budget, rows):
    """Under arbitrarily tight budgets every allocation is a valid grid
    value >= the minimum (no negative-demand artifacts)."""
    demands = [CacheDemand(i, a, pc, pi, w)
               for i, (a, pc, pi, w) in enumerate(rows)]
    out = cache_allocation(demands, SPACES, node_budget_mb=budget)
    assert set(out) == {d.client_id for d in demands}
    for mb in out.values():
        assert mb in SPACES.dirty_cache_mb
        assert mb >= SPACES.cache_min


def test_cache_allocation_normalizes_write_share_once():
    """Regression for the double normalization: NodeCacheArbiter used to
    pre-divide each member's write volume by the node total before
    cache_allocation renormalized again. The allocator now owns the only
    normalization, and — since factor (3) is scale-invariant — raw
    volumes must yield the exact allocations the pre-divided shares did."""
    from dataclasses import replace

    raw = [
        CacheDemand(0, True, 5 * 2**20, 0.0, 3.0e6),
        CacheDemand(1, True, 0.0, 9 * 2**20, 1.0e6),
        CacheDemand(2, False, 0.0, 0.0, 2.0e6),    # idle still carries volume
        CacheDemand(3, True, 2**20, 2**20, 0.0),
    ]
    total = sum(d.write_rpc_share for d in raw)    # old arbiter-side divisor
    pre_divided = [replace(d, write_rpc_share=d.write_rpc_share / total)
                   for d in raw]
    for budget in (256.0, 1024.0, 3000.0):
        assert cache_allocation(raw, SPACES, budget) == \
               cache_allocation(pre_divided, SPACES, budget)


def test_snap_cache_up():
    assert SPACES.snap_cache_up(0) == SPACES.cache_min
    assert SPACES.snap_cache_up(65) == 128
    assert SPACES.snap_cache_up(10**9) == SPACES.cache_max


def test_spaces_validation():
    with pytest.raises(ValueError):
        CaratSpaces((64, 16), (1,), (64,))      # unsorted grid
