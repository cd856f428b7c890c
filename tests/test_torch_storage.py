"""The port's PFS model, twinned with ``tests/test_storage.py``:
invariants (hypothesis) + mechanism directions, on ``"scalar"``."""
import functools

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.storage import Simulation, get_workload
from repro_torch.storage.client import ClientConfig
from repro_torch.storage.sim import run_static
from repro_torch.storage.workloads import WORKLOADS, WorkloadSpec

# the reference's tests run on its default backend, ``"scalar"``; the
# port's default is the device fleet (``"soa-torch"`` on ``cuda``)
Simulation = functools.partial(Simulation, backend="scalar")
run_static = functools.partial(run_static, backend="scalar")

CONFIG_GRID = st.tuples(
    st.sampled_from([16, 64, 256, 1024]),
    st.sampled_from([1, 8, 64, 256]),
    st.sampled_from([64, 512, 2048]),
)


@settings(max_examples=20, deadline=None)
@given(cfg=CONFIG_GRID, name=st.sampled_from(
    ["s_wr_sq_1m", "s_wr_rn_8k", "s_rd_rn_8k", "f_rd_sq_1m"]))
def test_throughput_positive_and_finite(cfg, name):
    thr = run_static(get_workload(name), ClientConfig(*cfg), duration_s=8.0)
    assert np.isfinite(thr)
    assert thr > 0


@settings(max_examples=15, deadline=None)
@given(cfg=CONFIG_GRID, seed=st.integers(0, 5))
def test_dirty_cache_never_exceeds_limit(cfg, seed):
    wl = get_workload("s_wr_rn_1m")
    sim = Simulation([wl], configs=[ClientConfig(*cfg)], seed=seed)
    cap = cfg[2] * 1024 * 1024
    for _ in range(30):
        sim.step()
        assert sim.clients[0].dirty_bytes <= cap + 1.0


@settings(max_examples=15, deadline=None)
@given(cfg=CONFIG_GRID)
def test_write_byte_conservation(cfg):
    """admitted bytes == drained + absorbed + still-dirty (fluid ledger)."""
    wl = get_workload("s_wr_sq_16m")
    sim = Simulation([wl], configs=[ClientConfig(*cfg)], seed=0)
    sim.run(10.0)
    st_ = sim.clients[0].stats
    lhs = st_.write.app_bytes
    rhs = (st_.write.rpc_bytes + st_.write.absorbed_bytes
           + sim.clients[0].dirty_bytes)
    assert lhs == pytest.approx(rhs, rel=0.02)


def test_determinism():
    wl = get_workload("s_wr_rn_8k")
    a = run_static(wl, ClientConfig(), duration_s=10.0, seed=3)
    b = run_static(wl, ClientConfig(), duration_s=10.0, seed=3)
    assert a == b


def test_random_read_prefers_small_window():
    """Paper §I: small random I/O benefits from smaller RPC windows."""
    wl = get_workload("s_rd_rn_8k")
    small = run_static(wl, ClientConfig(16, 8, 2048), duration_s=10.0)
    large = run_static(wl, ClientConfig(1024, 8, 2048), duration_s=10.0)
    assert small > 1.5 * large


def test_seq_read_benefits_from_inflight():
    """Table V mechanism: (64, 256) beats (1024, 8) for seq reads."""
    wl = get_workload("s_rd_sq_8k")
    deep = run_static(wl, ClientConfig(64, 256, 2048), duration_s=10.0)
    shallow = run_static(wl, ClientConfig(1024, 1, 2048), duration_s=10.0)
    assert deep > shallow


def test_inplace_updates_absorbed_by_cache():
    """Fig 6(d): 1m writes with in-place updates exceed drain throughput."""
    wl = get_workload("s_wr_sq_1m")
    assert wl.inplace_frac > 0
    big_cache = run_static(wl, ClientConfig(1024, 64, 2048), duration_s=15.0)
    tiny_cache = run_static(wl, ClientConfig(1024, 64, 64), duration_s=15.0)
    assert big_cache > tiny_cache


def test_interference_couples_clients():
    """A heavy neighbor on the same OST lowers a victim's throughput."""
    victim = get_workload("s_rd_sq_1m")
    noise = get_workload("s_wr_sq_16m")
    alone = Simulation([victim], seed=0, stripe_offsets=[0])
    r_alone = alone.run(10.0).client_mean_throughput(0)
    shared = Simulation([victim, noise], seed=0, stripe_offsets=[0, 0])
    r_shared = shared.run(10.0).client_mean_throughput(0)
    assert r_shared < 0.9 * r_alone


def test_strided_write_beats_random_small_blocks():
    """stride_bytes is honoured: an MPI-IO-style strided write fills
    extents structurally (contiguity = min(stride run, window)), unlike
    arrival-limited random fill."""
    KiB = 1024
    strided = WorkloadSpec("st", "write", "strided", 64 * KiB,
                           stride_bytes=256 * KiB, file_bytes=4 << 30)
    rand = WorkloadSpec("rn", "write", "random", 64 * KiB,
                        file_bytes=4 << 30)
    t_st = run_static(strided, ClientConfig(), duration_s=10.0)
    t_rn = run_static(rand, ClientConfig(), duration_s=10.0)
    assert t_st > 1.5 * t_rn


def test_strided_read_between_random_and_seq():
    """Stride-detected readahead pipelines strided reads: faster than
    latency-bound random, slower than fully sequential."""
    KiB = 1024
    mk = lambda acc, stride: WorkloadSpec(  # noqa: E731
        acc, "read", acc, 8 * KiB, stride_bytes=stride, file_bytes=1 << 30)
    t_st = run_static(mk("strided", 64 * KiB), ClientConfig(),
                      duration_s=10.0)
    t_rn = run_static(mk("random", 0), ClientConfig(), duration_s=10.0)
    t_sq = run_static(mk("seq", 0), ClientConfig(), duration_s=10.0)
    assert t_st > 2.0 * t_rn
    assert t_st < t_sq


def test_strided_requires_stride():
    with pytest.raises(ValueError):
        WorkloadSpec("bad", "read", "strided", 8192)    # stride_bytes=0
    with pytest.raises(ValueError):
        WorkloadSpec("bad", "read", "seq", 8192, stride_bytes=-1)


def test_burst_duty_cycle_gates_activity():
    wl = get_workload("dlio_bert")
    assert wl.active(0.1)
    assert not wl.active(wl.duty_cycle * wl.period_s + 0.05)


def test_workload_registry_complete():
    # 24 filebench + 2 dlio + 2 h5bench
    assert len(list(WORKLOADS)) >= 28


def test_ost_service_uses_page_size_constant(monkeypatch):
    """Regression: the OST service-time and byte-rate math hardcoded
    ``4096.0`` instead of ``params.PAGE_SIZE`` — under a different page
    size the served bytes must scale with it, and the batch resolver
    must agree with the scalar one."""
    import repro_torch.storage.client as client_mod
    import repro_torch.storage.pfs as pfs_mod
    from repro_torch.storage.client import ChannelDemand
    from repro_torch.storage.params import PFSParams
    from repro_torch.storage.soa import DemandBatch
    from repro_torch.utils.rng import RngStream

    def set_page(page_size):
        monkeypatch.setattr(pfs_mod, "PAGE_SIZE", page_size)
        monkeypatch.setattr(client_mod, "PAGE_SIZE", page_size)

    def demands():
        return [ChannelDemand(client_id=0, ost=0, op="write",
                              rpc_rate=50.0, rpc_pages=64.0, window=4.0),
                ChannelDemand(client_id=1, ost=0, op="read",
                              rpc_rate=30.0, rpc_pages=16.0, window=2.0)]

    def served(page_size):
        set_page(page_size)
        cluster = pfs_mod.PFSCluster(PFSParams(n_osts=1, noise_sigma=0.0),
                                     RngStream(0, "t"))
        cluster.resolve(demands(), dt=0.5)
        return cluster.osts[0].served_bytes, cluster.osts[0].utilization

    bytes_4k, util_4k = served(4096.0)
    bytes_8k, util_8k = served(8192.0)
    assert bytes_8k != bytes_4k          # page size must reach the math
    assert util_8k > util_4k             # bigger pages -> more disk time

    # scalar and batch resolvers agree under the non-default page size
    set_page(8192.0)
    p = PFSParams(n_osts=2, noise_sigma=0.0)
    ca = pfs_mod.PFSCluster(p, RngStream(1, "t"))
    cb = pfs_mod.PFSCluster(p, RngStream(1, "t"))
    ds = demands() + [ChannelDemand(client_id=2, ost=1, op="write",
                                    rpc_rate=10.0, rpc_pages=256.0,
                                    window=8.0)]
    fa = ca.resolve(ds, dt=0.5)
    batch = DemandBatch(
        ost=np.array([d.ost for d in ds], dtype=np.int64),
        rpc_rate=np.array([d.rpc_rate for d in ds]),
        rpc_pages=np.array([d.rpc_pages for d in ds]),
        window=np.array([d.window for d in ds]),
        ordinal=np.arange(len(ds), dtype=np.int64))
    fb = cb.resolve_batch(batch, dt=0.5)
    assert fa.waits == fb.waits
    assert fa.scale == fb.scale
    for oa, ob in zip(ca.osts, cb.osts):
        assert oa.served_bytes == ob.served_bytes
        assert oa.utilization == ob.utilization


# ------------------------------------------- run_static against the reference
@pytest.mark.parametrize("backend", ["scalar", "soa", "soa-torch"])
@pytest.mark.parametrize("name,cfg", [("s_rd_rn_8k", (16, 8, 2048)),
                                      ("s_wr_sq_1m", (1024, 64, 64))])
def test_run_static_matches_reference(backend, name, cfg):
    """``==`` the reference on the host backends (its ``run_static`` on
    ``scalar``; the same run on its ``soa``), ``rtol=1e-9`` of its ``soa``
    for the device fleet on the CPU."""
    import repro.storage as ref_storage
    from repro.storage.sim import run_static as ref_run_static
    from repro_torch.storage.sim import run_static as port_run_static
    kw = dict(duration_s=6.0, seed=3)
    got = port_run_static(get_workload(name), ClientConfig(*cfg),
                          backend=backend, device="cpu", **kw)
    if backend == "scalar":
        want = ref_run_static(ref_storage.get_workload(name),
                              ref_storage.ClientConfig(*cfg), **kw)
    else:
        want = ref_storage.Simulation(
            [ref_storage.get_workload(name)],
            configs=[ref_storage.ClientConfig(*cfg)], seed=3,
            backend="soa").run(6.0).client_mean_throughput(0)
    assert got > 0
    if backend == "soa-torch":
        assert got == pytest.approx(want, rel=1e-9, abs=0)
    else:
        assert got == want


def test_run_static_defaults_to_the_device_fleet():
    import torch
    from repro_torch.storage.sim import run_static as port_run_static
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default holds there")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_run_static(get_workload("s_rd_rn_8k"), ClientConfig(),
                        duration_s=1.0)
