"""The port's GBDT scoring (``repro_torch.kernels.gbdt_infer``) against the
reference package's.

On the CPU the wrappers run their plain torch versions, which carry the
kernels' float32 summation order; they are held bit-identical to
``ObliviousGBDT.decision_function`` and the reference's numpy grid
scorer, and within the reference kernel tests' ``atol=2e-6`` (on
probabilities, ``tests/test_kernels.py``) of the Pallas kernel run in
interpret mode. The kernels themselves are tested on a card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.core.ml.gbdt import train_gbdt as ref_train_gbdt
from repro.kernels.gbdt_infer.ops import GridGBDTScorer as RefGridScorer
from repro.kernels.gbdt_infer.ops import gbdt_predict_proba as ref_predict
from repro.kernels.gbdt_infer.ops import pack_gbdt as ref_pack
from repro_torch.configs.carat_defaults import SPACES
from repro_torch.core.ml.gbdt import (ObliviousGBDT, default_models,
                                      gbdt_from_reference, load_gbdt,
                                      save_gbdt)
from repro_torch.device import resolve_device
from repro_torch.kernels.gbdt_infer import kernel
from repro_torch.kernels.gbdt_infer.kernel import (gbdt_grid_logits,
                                                   gbdt_logits,
                                                   pairwise_levels)
from repro_torch.kernels.gbdt_infer.ops import (GBDTScorer, GridGBDTScorer,
                                                gbdt_predict_proba,
                                                pack_gbdt)
from repro_torch.kernels.gbdt_infer.ref import pairwise_sum

THETA = SPACES.theta_features()


def _port(m) -> ObliviousGBDT:
    return gbdt_from_reference(m.feat, m.thr, m.leaf, m.base, m.n_features)


def _rows(seed, n, f, scale=1.0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return (rng.normal(size=(n, f)) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def trained_gbdt():
    """The reference kernel tests' model (80 trees of depth 5, 22 features)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 22)).astype(np.float32)
    y = ((X[:, 0] * X[:, 3] + X[:, 7] > 0)).astype(np.int32)
    return ref_train_gbdt(X, y, n_trees=80, depth=5)


# ------------------------------------------------------------ summation order
@pytest.mark.parametrize("n", [1, 5, 7, 8, 9, 64, 127, 128, 129, 184, 223,
                               400, 1000])
def test_pairwise_sum_matches_numpy_float32_sum(n):
    x = _rows(n, 200, n, scale=3.0)
    got = pairwise_sum(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, x.sum(axis=1))


def test_pairwise_levels_cover_production_tree_counts():
    assert pairwise_levels(128) == 0 and pairwise_levels(129) == 1
    assert max(pairwise_levels(t) for t in range(1, 1025)) \
        <= kernel.MAX_PAIRWISE_LEVELS
    with pytest.raises(ValueError):
        kernel._check_trees(200_000, 1)


# -------------------------------------------------- cross-product gbdt_logits
@pytest.mark.parametrize("which", ["trained", "read", "write"])
def test_plain_logits_bit_identical_to_decision_function(
        which, trained_gbdt, tiny_models):
    ref = trained_gbdt if which == "trained" else tiny_models[which]
    model = _port(ref)
    packed = pack_gbdt(model, device="cpu")
    X = _rows(11, 300, model.n_features)
    got = gbdt_logits(torch.from_numpy(X), packed.feat, packed.thr,
                      packed.leaf, packed.base).numpy()
    assert np.array_equal(got, model.decision_function(X))
    assert np.array_equal(got, ref.decision_function(X))
    assert np.array_equal(GBDTScorer(model, device="cpu").predict_proba(X),
                          ref.predict_proba(X))


@pytest.mark.parametrize("n", [1, 63, 200])
def test_plain_logits_match_pallas_kernel_and_jnp_oracle(trained_gbdt, n):
    X = _rows(n, n, 22)
    got = gbdt_predict_proba(pack_gbdt(_port(trained_gbdt), device="cpu"), X)
    ref_packed = ref_pack(trained_gbdt)
    for backend in ("pallas", "jnp"):
        want = ref_predict(ref_packed, X, backend=backend, interpret=True)
        np.testing.assert_allclose(got, want, atol=2e-6, err_msg=backend)


# ------------------------------------------------------- grid scorer (fleet)
@pytest.mark.parametrize("op", ["read", "write"])
@pytest.mark.parametrize("seed,n", [(0, 1), (1, 8), (2, 37)])
def test_grid_scorer_bit_identical_to_reference_numpy(tiny_models, op, seed,
                                                      n):
    ref = tiny_models[op]
    H = _rows(seed, n, 20, scale=0.5)
    want = RefGridScorer(ref, THETA, backend="numpy")(H)
    got = GridGBDTScorer(_port(ref), THETA, device="cpu")(H)
    assert got.dtype == want.dtype and got.shape == (n, len(THETA))
    assert np.array_equal(got, want)
    # and to the per-client cross product (tests/test_fleet.py:54)
    X = np.concatenate([np.broadcast_to(H[0], (len(THETA), 20)), THETA],
                       axis=1).astype(np.float32)
    assert np.array_equal(got[0], ref.predict_proba(X))


def test_grid_scorer_rejects_bad_rows(tiny_models):
    sc = GridGBDTScorer(_port(tiny_models["read"]), THETA, device="cpu")
    with pytest.raises(ValueError):
        sc(np.zeros((3, 19), dtype=np.float32))
    assert sc(np.zeros(20, dtype=np.float32)).shape == (1, len(THETA))


# ----------------------------------------------------------------- weights
def test_gbdt_from_reference_and_npz_round_trip(tiny_models, tmp_path):
    ref = tiny_models["write"]
    model = _port(ref)
    assert model.feat.dtype == np.int32 and model.thr.dtype == np.float32
    path = str(tmp_path / "m.npz")
    save_gbdt(model, path)
    back = load_gbdt(path)
    for f in ("feat", "thr", "leaf"):
        assert np.array_equal(getattr(back, f), getattr(ref, f))
    assert back.base == ref.base and back.n_features == ref.n_features


def test_committed_models_are_the_reference_production_pair(tiny_models):
    """The assets are the reference's seed-0 ``get_default_models()``."""
    for mine, ref in zip(default_models(), (tiny_models["read"],
                                            tiny_models["write"])):
        for f in ("feat", "thr", "leaf"):
            assert np.array_equal(getattr(mine, f), getattr(ref, f))
        assert mine.base == ref.base


# ----------------------------------------------------------- no fallback
def test_cuda_request_without_cuda_raises(tiny_models, monkeypatch):
    """Asking for CUDA where there is none raises; nothing drops to the
    CPU quietly (the default device is CUDA)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _port(tiny_models["read"])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        GridGBDTScorer(model, THETA)
    with pytest.raises(RuntimeError, match="CUDA"):
        GBDTScorer(model, device="cuda")


def test_wrappers_reject_a_device_they_have_no_kernel_for(tiny_models):
    """A tensor that is neither on the CPU nor on a CUDA device, or model
    operands on another device than the rows, raise before any launch."""
    model = _port(tiny_models["read"])
    packed = pack_gbdt(model, device="cpu")
    sc = GridGBDTScorer(model, THETA, device="cpu")
    meta = {k: getattr(packed, k).to("meta") for k in ("feat", "thr", "leaf")}
    before = dict(kernel.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        gbdt_logits(torch.zeros((4, 22), device="meta"), meta["feat"],
                    meta["thr"], meta["leaf"], packed.base)
    with pytest.raises(ValueError, match="expected cpu"):
        gbdt_logits(torch.zeros((4, 22)), meta["feat"], meta["thr"],
                    meta["leaf"], packed.base)
    grid_ops = [t.to("meta") for t in (sc.cfeat, sc.thr, sc.idx_theta,
                                       sc.leaf_flat)]
    with pytest.raises(ValueError, match="unsupported device"):
        gbdt_grid_logits(torch.zeros((4, 20), device="meta"), *grid_ops)
    assert kernel.launches == before
