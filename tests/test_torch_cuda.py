"""The port on a CUDA device: kernels, fleet, CARAT loop, the sharded
runtime and CARAT's nets.

Every test here is marked ``cuda`` and skips without a CUDA device. On a
card each one asserts that the kernel it covers actually launched (its
launch counter moved), so a run that scored through anything else fails.
This file imports only the port, NumPy and torch, so it runs on a
machine without JAX::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import functools
import threading

import numpy as np
import pytest
import torch

from repro_torch.config import CaratConfig
from repro_torch.configs.carat_defaults import SPACES
from repro_torch.core.ml.gbdt import ObliviousGBDT, default_models
from repro_torch.core.ml.nets import FCNN, TCN, VanillaRNN, train_net
from repro_torch.core.policies.carat import CaratPolicy
from repro_torch.kernels.gbdt_infer import kernel
from repro_torch.kernels.gbdt_infer.kernel import gbdt_grid_logits
from repro_torch.kernels.gbdt_infer.ops import (GBDTScorer, GridGBDTScorer,
                                                pack_gbdt)
from repro_torch.kernels.gbdt_infer.ref import (gbdt_grid_logits_ref,
                                                gbdt_logits_ref)
from repro_torch.core.runtime.sharded import ShardedRuntime
from repro_torch.storage import (SchedulePolicy, Simulation, get_workload,
                                 schedule_from_names)
from repro_torch.storage.device import ShardedDeviceFleet

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


@functools.lru_cache(maxsize=None)
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
    assert fleet.device_fleet._states[0]["dirty"].device.type == "cuda"
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


# ------------------------------------------------------ the sharded runtime
def test_sharded_fleet_on_cuda_within_tolerance(dev):
    """Sync ``ShardedRuntime`` over a ``soa-torch`` sim on the card: the
    shards live on indexed ``cuda`` devices, one block per card, their
    totals come back through the host, and the fleet stays within
    ``rtol=1e-9`` of the single-device fleet (equal to it where every
    shard shares one card)."""
    topo = [i // 16 for i in range(512)]
    wls = [get_workload(WL_CYCLE[i % 4]) for i in range(512)]
    single = Simulation(wls, seed=4, device=dev, topology=topo)
    sharded = Simulation(wls, seed=4, device=dev, topology=topo)
    ra = single.run(6.0)
    rt = ShardedRuntime(sharded, mode="sync", n_shards=3)
    rb = rt.run(6.0)
    fleet = rt.device_fleet
    assert isinstance(fleet, ShardedDeviceFleet)
    count = torch.cuda.device_count()
    assert fleet.shard_devices == [torch.device("cuda", i % count)
                                   for i in range(3)]
    assert fleet.device == torch.device("cuda", 0)
    assert len(fleet.blocks) == min(3, count)
    assert all(st["dirty"].device.type == "cuda" for st in fleet._states)
    if count == 1:
        assert rb.app_write_bytes == ra.app_write_bytes
        assert rb.client_throughput == ra.client_throughput
    np.testing.assert_allclose(rb.app_read_bytes, ra.app_read_bytes,
                               rtol=1e-9)
    np.testing.assert_allclose(rb.app_write_bytes, ra.app_write_bytes,
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(rb.client_throughput),
                               np.asarray(ra.client_throughput),
                               rtol=1e-8, atol=1e-6)
    single.core.ensure_host()
    sharded.core.ensure_host()
    for op in ("read", "write"):
        for f in ("app_bytes", "rpc_count", "lat_sum_s", "blocked_s"):
            np.testing.assert_allclose(
                getattr(getattr(sharded.core, op), f),
                getattr(getattr(single.core, op), f), rtol=1e-9, atol=1e-12)


_FLIP = {"s_rd_rn_8k": "s_wr_rn_8k", "s_wr_rn_8k": "s_rd_rn_8k",
         "s_rd_sq_1m": "s_wr_sq_1m", "s_wr_sq_1m": "s_rd_sq_1m"}


def _flip_sim(backend, device, n=64):
    """``n`` clients in nodes of 16 whose op direction flips at 3 s, so
    every controller re-probes and takes a bootstrap pick."""
    names = [WL_CYCLE[i % 4] for i in range(n)]
    sim = Simulation([get_workload(nm) for nm in names], seed=0,
                     backend=backend, device=device,
                     topology=[i // 16 for i in range(n)])
    sim.attach_policy(SchedulePolicy({
        c.client_id: schedule_from_names([nm, _FLIP[nm]], phase_s=3.0)
        for c, nm in zip(sim.clients, names)}))
    return sim


def test_carat_bus_round_on_cuda_launches_both_kernels(dev):
    """CARAT's bus rounds on the card score every probe batch through
    ``gbdt_grid_logits`` and the bootstrap picks through ``gbdt_logits``,
    and make the decisions of the single-process loop with the plain
    versions."""
    r, w = default_models()
    models = {"read": r, "write": w}
    host = _flip_sim("soa", "cpu")
    want = host.attach_policy(CaratPolicy(SPACES, models, CaratConfig(),
                                          device="cpu"))
    host.run(6.0)
    sim = _flip_sim("soa", dev)
    policy = sim.attach_policy(CaratPolicy(SPACES, models, CaratConfig(),
                                           device=dev))
    rt = ShardedRuntime(sim, mode="sync", n_shards=4)
    kernel.reset_launches()
    rt.run(6.0)
    assert kernel.launches["gbdt_grid_logits"] > 0
    assert kernel.launches["gbdt_logits"] > 0
    assert any(want.decisions) and policy.decisions == want.decisions


def test_async_coordinator_thread_launches_kernels(dev):
    """Async mode on a host ``soa`` sim with a ``cuda`` policy: the
    coordinator loop (on the calling thread, while one thread per shard
    steps the host fleet) launches the GBDT kernels in its bus rounds,
    and every shard completes every interval within the staleness
    bound."""
    r, w = default_models()
    sim = _flip_sim("soa", dev)
    policy = sim.attach_policy(CaratPolicy(SPACES, {"read": r, "write": w},
                                           CaratConfig(), device=dev))
    rt = ShardedRuntime(sim, mode="async", max_staleness_intervals=2,
                        n_shards=4)
    kernel.reset_launches()
    rt.run(6.0)
    assert all(s.interval == 12 for s in rt.shards)
    assert rt.bus.stats()["max_staleness_seen"] <= 2
    assert policy.decision_count > 0
    assert kernel.launches["gbdt_grid_logits"] > 0



def test_bus_rounds_launch_kernels_from_a_worker_thread(dev):
    """The sync runtime driven from a thread other than the main one: its
    bus rounds launch both GBDT kernels from there (the wrappers launch
    on the tensors' device and its current stream, whatever the thread's
    current device) and make the decisions of the single-process loop
    with the plain versions."""
    r, w = default_models()
    models = {"read": r, "write": w}
    host = _flip_sim("soa", "cpu")
    want = host.attach_policy(CaratPolicy(SPACES, models, CaratConfig(),
                                          device="cpu"))
    host.run(6.0)
    sim = _flip_sim("soa", dev)
    policy = sim.attach_policy(CaratPolicy(SPACES, models, CaratConfig(),
                                           device=dev))
    rt = ShardedRuntime(sim, mode="sync", n_shards=4)
    errors = []

    def drive():
        try:
            rt.run(6.0)
        except BaseException as e:   # surfaced on the test's thread
            errors.append(e)

    kernel.reset_launches()
    worker = threading.Thread(target=drive, name="bus-rounds")
    worker.start()
    worker.join()
    assert not errors, errors
    assert kernel.launches["gbdt_grid_logits"] > 0
    assert kernel.launches["gbdt_logits"] > 0
    assert any(want.decisions) and policy.decisions == want.decisions

# ------------------------------------------ the pairwise plan's boundaries
TREE_COUNTS = [1, 7, 8, 9, 127, 128, 129, 184, 223, 400, 1000]
ROW_COUNTS = [1, 31, 32, 33, 63, 64, 4096]


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _check_logits(dev, model, X):
    """``gbdt_logits`` on ``X``: one launch, equal to the plain version on
    the card and to ``decision_function`` bit for bit."""
    packed = pack_gbdt(model, dev)
    x = torch.from_numpy(X).to(dev)
    args = (x, packed.feat, packed.thr, packed.leaf, packed.base)
    before = kernel.launches["gbdt_logits"]
    got = kernel.gbdt_logits(*args)
    torch.cuda.synchronize(dev)
    assert kernel.launches["gbdt_logits"] == before + 1
    assert torch.equal(got, gbdt_logits_ref(*args))
    assert np.array_equal(_bits(got.cpu().numpy()),
                          _bits(model.decision_function(X)))


def _check_grid(dev, model, H, theta=THETA):
    """``gbdt_grid_logits`` through ``GridGBDTScorer``: one launch, equal
    to the CPU scorer's probabilities and, on the card, to the plain
    version's logits."""
    sc = GridGBDTScorer(model, theta, device=dev)
    before = kernel.launches["gbdt_grid_logits"]
    got = sc(H)
    assert kernel.launches["gbdt_grid_logits"] == before + 1
    assert np.array_equal(got, GridGBDTScorer(model, theta, "cpu")(H))
    args = (torch.from_numpy(H).to(dev), sc.cfeat, sc.thr, sc.idx_theta,
            sc.leaf_flat)
    assert torch.equal(gbdt_grid_logits(*args), gbdt_grid_logits_ref(*args))


@pytest.mark.parametrize("trees", TREE_COUNTS)
@pytest.mark.parametrize("n", ROW_COUNTS)
def test_logits_kernel_at_pairwise_boundaries(dev, trees, n):
    """Tree counts on each side of the plan's boundaries (8 accumulators,
    a 128-tree leaf block, a split) over row counts on each side of a
    warp and of a block's 64-row tile."""
    model = _random_model(trees, trees)
    _check_logits(dev, model, _rows(n + trees, n, model.n_features))


@pytest.mark.parametrize("which", ["read", "write"])
def test_logits_kernel_at_fleet_size(dev, which):
    """258,048 rows: the cross product of a 4096-client probe batch."""
    model = _models()[which]
    _check_logits(dev, model, _rows(5, 4096 * 63, model.n_features))


def test_logits_kernel_deep_trees_and_wide_rows(dev):
    """Depth 12 and 16 (leaves far past one line; at 184 trees of depth
    12 the model is read through L1), and rows too wide for the staged
    tile (read through L1)."""
    _check_logits(dev, _random_model(9, 3, depth=12),
                  _rows(6, 100, 22))
    _check_logits(dev, _random_model(3, 4, depth=16),
                  _rows(7, 70, 22))
    assert not kernel.logits_geometry(300, 22, 184, 12).stage_model
    _check_logits(dev, _random_model(184, 6, depth=12),
                  _rows(8, 300, 22))
    wide = _random_model(130, 5, n_features=2000)
    assert not kernel.logits_geometry(100, 2000, 130, 5).stage_x
    _check_logits(dev, wide, _rows(8, 100, 2000))


def _with_specials(X, seed):
    """``X`` with NaN, +inf and -inf in seeded places, and a row of each."""
    rng = np.random.Generator(np.random.PCG64(seed))
    X = X.copy()
    mask = rng.random(X.shape)
    X[mask < 0.05] = np.nan
    X[(mask >= 0.05) & (mask < 0.1)] = np.inf
    X[(mask >= 0.1) & (mask < 0.15)] = -np.inf
    X[0], X[1], X[2] = np.nan, np.inf, -np.inf
    return X


@pytest.mark.parametrize("which", ["read", "write", "t1000"])
def test_kernels_take_nan_and_inf_features(dev, which):
    model = _models()[which]
    _check_logits(dev, model, _with_specials(_rows(9, 200, 22), 10))
    H = _with_specials(_rows(11, 150, model.n_features - THETA.shape[1]), 12)
    _check_grid(dev, model, H)


@pytest.mark.parametrize("trees", TREE_COUNTS)
def test_grid_kernel_at_pairwise_boundaries(dev, trees):
    """1, 300 and 4096 clients, and more clients than the persistent
    grid's blocks take in one pass each."""
    model = _random_model(trees, trees)
    n_h = model.n_features - THETA.shape[1]
    geo = kernel.grid_geometry(1 << 20, len(THETA), trees, model.depth,
                               torch.cuda.get_device_properties(
                                   dev).multi_processor_count)
    many = 2 * geo.blocks * geo.clients_per_pass + 5
    for n in (1, 300, 4096, many):
        _check_grid(dev, model, _rows(n + trees, n, n_h, scale=0.5))


def test_grid_kernel_candidate_chunks_and_deep_trees(dev):
    """300 candidates (two chunks of 256, the model staged a leaf block at
    a time) and depth 16 (leaves gathered through L1)."""
    rng = np.random.Generator(np.random.PCG64(13))
    theta = rng.normal(size=(300, THETA.shape[1])).astype(np.float32)
    model = _random_model(223, 14)
    n_h = model.n_features - THETA.shape[1]
    assert not kernel.grid_geometry(70, 300, 223, 5).resident
    _check_grid(dev, model, _rows(15, 70, n_h, scale=0.5), theta)
    deep = _random_model(5, 16, depth=16)
    assert not kernel.grid_geometry(40, 63, 5, 16).stage_leaves
    _check_grid(dev, deep, _rows(17, 40, n_h, scale=0.5))


def test_kernels_in_a_cuda_graph(dev):
    """Both kernels captured once and replayed after their inputs change
    in place: the new answers, so the wrappers read no device value on
    the host."""
    r, w = default_models()
    packed = pack_gbdt(w, dev)
    sc = GridGBDTScorer(r, THETA, device=dev)
    X0, X1 = _rows(18, 63, w.n_features), _rows(19, 63, w.n_features)
    H0, H1 = (_rows(20, 4096, sc.n_h, 0.5), _rows(21, 4096, sc.n_h, 0.5))
    x, h = torch.from_numpy(X0).to(dev), torch.from_numpy(H0).to(dev)
    grid_args = (h, sc.cfeat, sc.thr, sc.idx_theta, sc.leaf_flat)

    def both():
        return (kernel.gbdt_logits(x, packed.feat, packed.thr, packed.leaf,
                                   packed.base),
                gbdt_grid_logits(*grid_args))

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):      # warm-up off the default stream
        both()
    torch.cuda.current_stream(dev).wait_stream(side)
    before = dict(kernel.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, grid = both()
    assert kernel.launches["gbdt_logits"] == before["gbdt_logits"] + 1
    assert (kernel.launches["gbdt_grid_logits"]
            == before["gbdt_grid_logits"] + 1)
    x.copy_(torch.from_numpy(X1))
    h.copy_(torch.from_numpy(H1))
    graph.replay()
    torch.cuda.synchronize(dev)
    assert np.array_equal(_bits(logits.cpu().numpy()),
                          _bits(w.decision_function(X1)))
    assert torch.equal(grid, gbdt_grid_logits_ref(*grid_args))


# ------------------------------------------------------------ CARAT's nets
@pytest.mark.parametrize("arch_cls", [FCNN, VanillaRNN, TCN],
                         ids=["FCNN", "VanillaRNN", "TCN"])
def test_train_net_on_cuda_matches_cpu_forward(dev, arch_cls):
    """A few epochs on the card (the default device): the parameters stay
    there, and ``predict_proba`` equals the same weights' CPU forward at
    ``atol=1e-5`` with cuDNN's TF32 on, as torch leaves it by default (the
    TCN's convolution must not run through TF32). The CPU forward runs in
    float64: torch's float32 one on the CPU has drifted past ``1e-5`` on
    its first call in a process that ran the other tests here, while the
    card's stayed within ``2e-7`` of float64."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1500, 22)).astype(np.float32)
    y = (X[:, 0] ** 2 + X[:, 1] ** 2 > 1.4).astype(np.int32)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        m = train_net(arch_cls(22), X[:1200], y[:1200], X[1200:], y[1200:],
                      epochs=5)
        got = m.predict_proba(X)
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert m.steps > 0
    assert {p.device.type for p in m.module.parameters()} == {"cuda"}
    on_cpu = arch_cls(22)
    on_cpu.load_state_dict({k: v.cpu()
                            for k, v in m.module.state_dict().items()})
    Z = (X.astype(np.float64) - m.mu) / m.sigma
    with torch.no_grad():
        want = torch.sigmoid(on_cpu.double()(torch.from_numpy(Z))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
