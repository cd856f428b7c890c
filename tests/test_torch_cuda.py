"""The port on a CUDA device: kernels, fleet and CARAT loop.

Every test here is marked ``cuda`` and skips without a CUDA device. On a
card each one asserts that the kernel it covers actually launched (its
launch counter moved), so a run that scored through anything else fails.
This file imports only the port, NumPy and torch, so it runs on a
machine without JAX::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.config import CaratConfig
from repro_torch.configs.carat_defaults import SPACES
from repro_torch.core.ml.gbdt import ObliviousGBDT, default_models
from repro_torch.core.policies.carat import CaratPolicy
from repro_torch.kernels.gbdt_infer import kernel
from repro_torch.kernels.gbdt_infer.kernel import gbdt_grid_logits
from repro_torch.kernels.gbdt_infer.ops import (GBDTScorer, GridGBDTScorer,
                                                pack_gbdt)
from repro_torch.kernels.gbdt_infer.ref import (gbdt_grid_logits_ref,
                                                gbdt_logits_ref)
from repro_torch.storage import Simulation, get_workload

pytestmark = pytest.mark.cuda

THETA = SPACES.theta_features()
WL_CYCLE = ("s_rd_rn_8k", "s_wr_sq_1m", "s_rd_sq_1m", "s_wr_rn_8k")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rows(seed, n, f, scale=1.0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return (rng.normal(size=(n, f)) * scale).astype(np.float32)


def _random_model(n_trees, seed, depth=5, n_features=22):
    """A random oblivious ensemble: exercises tree counts past the trained
    ones (400 trees need dynamic shared memory above 48 KB)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return ObliviousGBDT(
        feat=rng.integers(0, n_features, size=(n_trees, depth)).astype(
            np.int32),
        thr=rng.normal(size=(n_trees, depth)).astype(np.float32),
        leaf=(rng.normal(size=(n_trees, 1 << depth)) * 0.1).astype(
            np.float32),
        base=0.3, n_features=n_features)


def _models():
    r, w = default_models()
    return {"read": r, "write": w, "t400": _random_model(400, 1),
            "t1000": _random_model(1000, 2)}


@pytest.mark.parametrize("which", ["read", "write", "t400", "t1000"])
@pytest.mark.parametrize("n", [1, 63, 4096])
def test_logits_kernel_bit_identical(dev, which, n):
    model = _models()[which]
    X = _rows(n, n, model.n_features)
    packed = pack_gbdt(model, dev)
    x = torch.from_numpy(X).to(dev)
    before = kernel.launches["gbdt_logits"]
    got = kernel.gbdt_logits(x, packed.feat, packed.thr, packed.leaf,
                             packed.base)
    torch.cuda.synchronize(dev)
    assert kernel.launches["gbdt_logits"] == before + 1
    plain = gbdt_logits_ref(x, packed.feat, packed.thr, packed.leaf,
                            packed.base)
    assert torch.equal(got, plain)
    assert np.array_equal(got.cpu().numpy(), model.decision_function(X))
    assert np.array_equal(GBDTScorer(model, dev).predict_proba(X),
                          model.predict_proba(X))


@pytest.mark.parametrize("which", ["read", "write", "t400", "t1000"])
@pytest.mark.parametrize("n", [1, 300])
def test_grid_kernel_bit_identical(dev, which, n):
    model = _models()[which]
    H = _rows(n + 7, n, model.n_features - THETA.shape[1], scale=0.5)
    sc = GridGBDTScorer(model, THETA, device=dev)
    before = kernel.launches["gbdt_grid_logits"]
    got = sc(H)
    assert kernel.launches["gbdt_grid_logits"] == before + 1
    assert np.array_equal(got, GridGBDTScorer(model, THETA, "cpu")(H))
    args = (torch.from_numpy(H).to(dev), sc.cfeat, sc.thr, sc.idx_theta,
            sc.leaf_flat)
    assert torch.equal(gbdt_grid_logits(*args), gbdt_grid_logits_ref(*args))


def test_wrapper_rejects_mixed_devices(dev):
    packed = pack_gbdt(_models()["read"], dev)
    with pytest.raises(ValueError):
        kernel.gbdt_logits(torch.zeros((4, 22)), packed.feat, packed.thr,
                           packed.leaf, packed.base)


def _fleet_pair(dev, n=512, seed=4):
    wls = [get_workload(WL_CYCLE[i % 4]) for i in range(n)]
    return (Simulation(wls, seed=seed, backend="soa"),
            Simulation(wls, seed=seed, backend="soa-torch", device=dev))


def test_device_fleet_on_cuda_within_tolerance(dev):
    host, fleet = _fleet_pair(dev)
    host.run(6.0)
    fleet.run(6.0)
    assert fleet.device_fleet._state["dirty"].device.type == "cuda"
    host.core.ensure_host()
    fleet.core.ensure_host()
    for op in ("read", "write"):
        for f in ("app_bytes", "rpc_count", "lat_sum_s", "blocked_s"):
            np.testing.assert_allclose(getattr(getattr(fleet.core, op), f),
                                       getattr(getattr(host.core, op), f),
                                       rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(fleet.cluster.wait_s, host.cluster.wait_s,
                               rtol=1e-9, atol=1e-15)


def test_carat_on_cuda_makes_the_host_decisions(dev):
    """The CARAT loop on the CUDA fleet and kernels makes the decisions of
    the same loop on the host core with the plain versions."""
    r, w = default_models()
    models = {"read": r, "write": w}
    runs = []
    for backend, device in (("soa", "cpu"), ("soa-torch", dev)):
        wls = [get_workload(WL_CYCLE[i % 4]) for i in range(64)]
        sim = Simulation(wls, seed=0, backend=backend, device=device,
                         topology=[i // 16 for i in range(64)])
        policy = sim.attach_policy(CaratPolicy(SPACES, models,
                                               CaratConfig(), device=device))
        kernel.reset_launches()
        sim.run(6.0)
        runs.append((policy.decisions, dict(kernel.launches)))
    (host_dec, host_launches), (dev_dec, dev_launches) = runs
    assert host_launches["gbdt_grid_logits"] == 0
    assert dev_launches["gbdt_grid_logits"] > 0
    assert any(host_dec) and dev_dec == host_dec
