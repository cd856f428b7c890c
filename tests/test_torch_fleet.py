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
    seen, onehot = fleet._static_seen, fleet._onehots[0]
    for sim in (a, b):
        sim.clients[0].set_rpc_config(64, 4)
        sim.clients[1].set_cache_limit(16)
    for sim in (a, b):
        sim.run(4.0)
    assert fleet._static_seen != seen
    assert fleet._onehots[0] is onehot
    _assert_close(a, b)
    for sim, pkg in ((a, ref_storage), (b, port_storage)):
        sim.clients[2].set_workload(pkg.WorkloadSpec(
            "wide", op="write", access="seq", req_bytes=1 << 20,
            n_streams=sim.p.n_osts + 3))
    for sim in (a, b):
        sim.run(3.0)
    assert fleet._onehots[0] is not onehot
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


# ------------------------------------------------------- shard -> device
def _sharded(sim, **kw):
    from repro_torch.core.runtime.sharded import ShardedRuntime
    return ShardedRuntime(sim, **kw)


def _blocked(sim, k):
    """Step ``sim`` through a fleet of ``k`` interleaved row blocks, all
    on the CPU: the multi-device merge path on one device."""
    from repro_torch.storage.device import DeviceFleet
    rows = np.arange(sim.core.n)
    sim.device_fleet = DeviceFleet(sim.core, sim.cluster, "cpu",
                                   blocks=[rows[rows % k == b]
                                           for b in range(k)])
    return sim.device_fleet


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_device_fleet_matches_single_device(n_shards):
    """``tests/test_soa_device.py``'s shard -> device case: a sync
    ``ShardedRuntime`` over a ``soa-torch`` sim steps through the
    sharded device fleet. Its shards share the one device, so they step
    as one block and equal the sim's own fleet bit for bit; both stay
    within ``rtol=1e-9`` of host ``soa``."""
    from repro_torch.storage.device import ShardedDeviceFleet
    topo = [i % 4 for i in range(8)]
    a = _port("soa-torch", n=8, topology=topo)
    ra = a.run(8.0)
    b = _port("soa-torch", n=8, topology=topo)
    rt = _sharded(b, mode="sync", n_shards=n_shards)
    rb = rt.run(8.0)
    assert isinstance(rt.device_fleet, ShardedDeviceFleet)
    assert b.core._device is rt.device_fleet
    assert len(rt.device_fleet.blocks) == 1
    assert rb.app_read_bytes == ra.app_read_bytes
    assert rb.app_write_bytes == ra.app_write_bytes
    assert rb.client_throughput == ra.client_throughput
    a.core.ensure_host()
    b.core.ensure_host()
    _assert_identical(a, b)
    host = _port("soa", n=8, topology=topo)
    host.run(8.0)
    _assert_close(host, b)


@pytest.mark.parametrize("n_blocks", [2, 3])
def test_device_fleet_blocks_within_tolerance(n_blocks):
    """Rows split into blocks (one per card on a machine with several):
    the partials merge across blocks in block order, within ``rtol=1e-9``
    of the one-block fleet and of host ``soa``, through ``sim.run`` and
    through the sync sharded runtime."""
    topo = [i // 4 for i in range(24)]
    one = _port("soa-torch", topology=topo)
    r1 = one.run(6.0)
    for via in ("sim", "runtime"):
        sim = _port("soa-torch", topology=topo)
        fleet = _blocked(sim, n_blocks)
        if via == "sim":
            res = sim.run(6.0)
        else:
            rt = _sharded(sim, mode="sync", n_shards=3)
            rt.device_fleet = fleet
            res = rt.run(6.0)
        assert sim.core._device is fleet and len(fleet.blocks) == n_blocks
        np.testing.assert_allclose(res.app_read_bytes, r1.app_read_bytes,
                                   rtol=1e-9)
        np.testing.assert_allclose(res.app_write_bytes, r1.app_write_bytes,
                                   rtol=1e-9)
        np.testing.assert_allclose(np.asarray(res.client_throughput),
                                   np.asarray(r1.client_throughput),
                                   rtol=1e-8, atol=1e-6)
        _assert_close(one, sim)
    host = _port("soa", topology=topo)
    host.run(6.0)
    _assert_close(host, sim)


def test_soa_torch_sim_is_device_sharded():
    """A ``soa-torch`` sim under the runtime always steps on its device
    in sync mode, and refuses async mode and the host straggler
    injection; a host sim steps on the host."""
    from repro_torch.storage.device import ShardedDeviceFleet
    topo = [0, 0, 1, 1, 2, 2, 3, 3]
    with pytest.raises(ValueError, match="backend='soa'"):
        _sharded(_port("soa-torch"), mode="async")
    with pytest.raises(ValueError, match="straggler"):
        _sharded(_port("soa-torch", n=8, topology=topo), n_shards=2,
                 straggler_delay_s={0: 0.1})
    rt = _sharded(_port("soa-torch", n=8, topology=topo), n_shards=3)
    assert isinstance(rt.device_fleet, ShardedDeviceFleet)
    assert rt.device_fleet.shard_devices == [torch.device("cpu")] * 3
    assert rt.device_fleet.devices == [torch.device("cpu")]
    assert rt.device_fleet.device == torch.device("cpu")
    for backend in ("soa", "scalar"):
        assert _sharded(_port(backend)).device_fleet is None
    assert _sharded(_port("soa"), mode="async").device_fleet is None


def test_auto_devices_are_indexed(monkeypatch):
    """On ``cuda``, ``"auto"`` puts shard ``i`` on card ``i % count`` and
    indexes every device, so ``torch.device("cuda")`` and the current
    card compare equal (no same-card copy)."""
    from repro_torch.storage.device import _indexed, shard_devices
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert _indexed("cuda") == torch.device("cuda", 1)
    assert _indexed(torch.device("cuda", 0)) == torch.device("cuda", 0)
    assert shard_devices("cuda", 3) == [torch.device("cuda", 0),
                                        torch.device("cuda", 1),
                                        torch.device("cuda", 0)]
    assert shard_devices("cpu", 2) == [torch.device("cpu")] * 2


def test_shards_on_one_device_form_one_block(monkeypatch):
    """``ShardedDeviceFleet`` groups the shards by device: with two cards
    and three shards, card 0 steps shards 0 and 2 as one block (rows in
    ascending order) and card 1 shard 1; nothing is put on a card until
    the first step."""
    from repro_torch.storage.device import ShardedDeviceFleet, shard_devices
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    sim = _port("soa-torch", n=12)
    idx = [np.array([0, 3, 6, 9]), np.array([1, 4, 7, 10]),
           np.array([2, 5, 8, 11])]
    fleet = ShardedDeviceFleet(sim.core, sim.cluster, idx,
                               shard_devices("cuda", 3), "cuda")
    assert fleet.device == torch.device("cuda", 0)
    assert fleet.devices == [torch.device("cuda", 0),
                             torch.device("cuda", 1)]
    assert [b.tolist() for b in fleet.blocks] == [[0, 2, 3, 5, 6, 8, 9, 11],
                                                  [1, 4, 7, 10]]


def test_ownership_round_trip():
    """``sim.run`` -> ``ShardedRuntime.run`` -> ``sim.run`` on one sim:
    each fleet takes the state over from the other through the host
    arrays, and the whole run stays within tolerance of host ``soa``."""
    topo = [i // 4 for i in range(16)]
    host = _port("soa", n=16, topology=topo)
    sim = _port("soa-torch", n=16, topology=topo)
    want = [host.run(3.0), host.run(3.0), host.run(3.0)]
    got = [sim.run(3.0)]
    rt = _sharded(sim, mode="sync", n_shards=2)
    got.append(rt.run(3.0))
    assert sim.core._device is rt.device_fleet
    assert sim.device_fleet.device_stale
    got.append(sim.run(3.0))
    assert sim.core._device is sim.device_fleet
    assert rt.device_fleet.device_stale
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(b.client_throughput),
                                   np.asarray(a.client_throughput),
                                   rtol=1e-8, atol=1e-6)
        np.testing.assert_allclose(b.app_write_bytes, a.app_write_bytes,
                                   rtol=1e-9)
    _assert_close(host, sim)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("trace", port_storage.bundled_traces())
def test_replay_corpus_on_device_fleet(trace, sharded):
    """The bundled corpus replayed on ``soa-torch`` (single device, and
    under the sync sharded runtime) stays within ``rtol=1e-9`` of host
    ``soa``: workload switches re-upload the statics mid-run."""
    tr = port_storage.load_bundled_trace(trace)
    res = {}
    for backend in ("soa", "soa-torch"):
        kw = {"device": "cpu"} if backend == "soa-torch" else {}
        sim, _ = port_storage.simulation_from_trace(tr, backend=backend,
                                                    **kw)
        if sharded and backend == "soa-torch":
            res[backend] = _sharded(sim, mode="sync", n_shards=2).run(12.0)
        else:
            res[backend] = sim.run(12.0)
    np.testing.assert_allclose(res["soa-torch"].app_read_bytes,
                               res["soa"].app_read_bytes, rtol=1e-9)
    np.testing.assert_allclose(res["soa-torch"].app_write_bytes,
                               res["soa"].app_write_bytes, rtol=1e-9)


def test_sharded_fleet_rebuilds_onehots_only_on_layout_change():
    """A blocked fleet's per-block one-hot OST maps survive a config
    change (statics re-uploaded) and are rebuilt when a workload change
    alters the channel layout; both stay within tolerance of host
    ``soa``."""
    topo = [i // 4 for i in range(24)]
    host = _port("soa", topology=topo)
    sim = _port("soa-torch", topology=topo)
    fleet = _blocked(sim, 3)
    host.run(3.0)
    sim.run(3.0)
    seen, onehots = fleet._static_seen, list(fleet._onehots)
    for s in (host, sim):
        s.clients[0].set_rpc_config(64, 4)
        s.clients[5].set_cache_limit(16)
    host.run(3.0)
    sim.run(3.0)
    assert fleet._static_seen != seen
    assert all(a is b for a, b in zip(fleet._onehots, onehots))
    _assert_close(host, sim)
    for s in (host, sim):
        s.clients[2].set_workload(port_storage.WorkloadSpec(
            "wide", op="write", access="seq", req_bytes=1 << 20,
            n_streams=s.p.n_osts + 3))
    host.run(3.0)
    sim.run(3.0)
    assert not any(a is b for a, b in zip(fleet._onehots, onehots))
    _assert_close(host, sim)
