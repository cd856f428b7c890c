"""The port's fleet backends against the reference package's.

* ``backend="soa"`` (the host NumPy core, copied) is bit-identical to the
  reference's ``soa``: same counters, same OST state, same RNG draws.
* ``backend="soa-torch"`` (the torch device fleet, run here on the CPU)
  reassociates its per-OST and per-channel sums, so it is held to the
  reference's ``soa`` and ``soa-jax`` at the reference's device tolerance,
  ``rtol=1e-9`` on the fields of ``tests/test_soa_device.py::_assert_close``.
"""
import numpy as np
import pytest
import torch

import repro.storage as ref_storage
import repro_torch.storage as port_storage
from repro_torch.storage.soa import OP_FIELDS

NAMES = sorted(ref_storage.WORKLOADS.keys())


@pytest.fixture(autouse=True)
def _restore_jax_x64():
    """The reference's ``soa-jax`` turns on JAX's float64 mode for the
    whole process; put the flag back after each test, so that the files
    a test worker runs after this one see JAX's default."""
    import jax
    before = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", before)


def _fleet(pkg, backend, n=24, n_osts=4, seed=2, **kw):
    wls = [pkg.get_workload(NAMES[i % len(NAMES)]) for i in range(n)]
    return pkg.Simulation(wls, params=pkg.PFSParams(n_osts=n_osts),
                          seed=seed, backend=backend, **kw)


def _port(backend, **kw):
    if backend == "soa-torch":
        kw.setdefault("device", "cpu")
    return _fleet(port_storage, backend, **kw)


def _assert_close(sa, sb, rtol=1e-9):
    """``tests/test_soa_device.py::_assert_close``: ``sb`` against ``sa``."""
    sa.core.ensure_host()
    sb.core.ensure_host()
    for op in ("read", "write"):
        for f in ("app_bytes", "rpc_count", "rpc_bytes", "lat_sum_s",
                  "blocked_s", "active_s", "inflight_time"):
            np.testing.assert_allclose(
                getattr(getattr(sb.core, op), f),
                getattr(getattr(sa.core, op), f),
                rtol=rtol, atol=1e-12, err_msg=f"{op}.{f}")
    np.testing.assert_allclose(sb.core.dirty_bytes, sa.core.dirty_bytes,
                               rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(sb.cluster.wait_s, sa.cluster.wait_s,
                               rtol=rtol, atol=1e-15)
    np.testing.assert_allclose(sb.cluster.served_bytes,
                               sa.cluster.served_bytes, rtol=rtol)


def _assert_identical(sa, sb):
    for op in ("read", "write"):
        for f in OP_FIELDS:
            assert np.array_equal(getattr(getattr(sb.core, op), f),
                                  getattr(getattr(sa.core, op), f)), \
                f"{op}.{f}"
    for f in ("dirty_bytes", "last_drain", "waits", "dirty_peak_bytes",
              "inflight_peak"):
        assert np.array_equal(getattr(sb.core, f), getattr(sa.core, f)), f
    for f in ("wait_s", "utilization", "inflight", "served_bytes",
              "served_rpcs"):
        assert np.array_equal(getattr(sb.cluster, f),
                              getattr(sa.cluster, f)), f


# ------------------------------------------------------------- host soa copy
@pytest.mark.parametrize("n,n_osts,seed", [(8, 4, 2), (40, 8, 7),
                                            (64, 3, 11)])
def test_host_soa_bit_identical_to_reference(n, n_osts, seed):
    a = _fleet(ref_storage, "soa", n=n, n_osts=n_osts, seed=seed)
    b = _port("soa", n=n, n_osts=n_osts, seed=seed)
    ra, rb = a.run(8.0), b.run(8.0)
    _assert_identical(a, b)
    assert ra.client_throughput == rb.client_throughput


# ----------------------------------------------------------- device fleet
@pytest.mark.parametrize("ref_backend", ["soa", "soa-jax"])
@pytest.mark.parametrize("n,n_osts,seed", [(24, 4, 2), (64, 8, 3)])
def test_device_fleet_within_tolerance_of_reference(ref_backend, n, n_osts,
                                                    seed):
    a = _fleet(ref_storage, ref_backend, n=n, n_osts=n_osts, seed=seed)
    b = _port("soa-torch", n=n, n_osts=n_osts, seed=seed)
    assert b.device_fleet is not None
    ra, rb = a.run(12.0), b.run(12.0)
    _assert_close(a, b)
    np.testing.assert_allclose(rb.client_throughput, ra.client_throughput,
                               rtol=1e-9, atol=1e-6)


def test_config_mutation_reuploads_statics_only():
    """A config change mid-run (what every actuation does) re-uploads the
    statics but not the one-hot OST map, whose layout is unchanged; a
    workload change that alters a stream count rebuilds the map. Both
    stay within tolerance of the reference."""
    a = _fleet(ref_storage, "soa")
    b = _port("soa-torch")
    for sim in (a, b):
        sim.run(4.0)
    fleet = b.device_fleet
    seen, onehot = fleet._static_seen, fleet._onehot_T
    for sim in (a, b):
        sim.clients[0].set_rpc_config(64, 4)
        sim.clients[1].set_cache_limit(16)
    for sim in (a, b):
        sim.run(4.0)
    assert fleet._static_seen != seen
    assert fleet._onehot_T is onehot
    _assert_close(a, b)
    for sim, pkg in ((a, ref_storage), (b, port_storage)):
        sim.clients[2].set_workload(pkg.WorkloadSpec(
            "wide", op="write", access="seq", req_bytes=1 << 20,
            n_streams=sim.p.n_osts + 3))
    for sim in (a, b):
        sim.run(3.0)
    assert fleet._onehot_T is not onehot
    _assert_close(a, b)


def test_host_views_read_through_device_state():
    """Mid-run per-client stat reads see the device state (lazy sync), and
    a host-path interval between device steps hands state back and forth
    without losing either side's writes."""
    a = _fleet(ref_storage, "soa")
    b = _port("soa-torch")
    for _ in range(6):
        a.step()
        b.step()
    assert b.device_fleet.host_stale
    for ca, cb in zip(a.clients, b.clients):
        np.testing.assert_allclose(cb.stats.read.app_bytes,
                                   ca.stats.read.app_bytes, rtol=1e-9)
        np.testing.assert_allclose(cb.stats.dirty_bytes,
                                   ca.stats.dirty_bytes, rtol=1e-9,
                                   atol=1e-6)
        np.testing.assert_allclose(
            [cb.last_wait[o] for o in sorted(cb.last_wait)],
            [ca.last_wait[o] for o in sorted(ca.last_wait)],
            rtol=1e-9, atol=1e-15)
    dt = a.interval_s
    for sim in (a, b):
        plans = sim.plan_phase(sim.clients, sim.t, dt)
        fb = sim.resolve_phase(plans, dt)
        sim.commit_phase(sim.clients, plans, fb, dt)
        sim.t += dt
    assert b.device_fleet.device_stale
    for _ in range(4):
        a.step()
        b.step()
    _assert_close(a, b)


def test_default_backend_is_the_cuda_fleet(monkeypatch):
    """``Simulation()`` defaults to ``soa-torch`` on CUDA and raises where
    there is none, instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wls = [port_storage.get_workload(NAMES[0])]
    with pytest.raises(RuntimeError, match="CUDA"):
        port_storage.Simulation(wls)
    sim = port_storage.Simulation(wls, device="cpu")
    assert sim.backend == "soa-torch"
    assert sim.device_fleet.device == torch.device("cpu")
    with pytest.raises(ValueError):
        port_storage.Simulation(wls, backend="soa-jax")
