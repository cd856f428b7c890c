"""The port's Table II metrics + snapshot builder, twinned with
``tests/test_metrics.py``, on ``"scalar"``."""
import functools

import numpy as np

from repro_torch.core.metrics import compute_metrics, normalize_features
from repro_torch.core.policies import PerClientPolicy
from repro_torch.core.snapshot import SnapshotBuilder
from repro_torch.storage import Simulation, get_workload
from repro_torch.storage.client import ClientConfig

# the reference's tests run on its default backend, ``"scalar"``; the
# port's default is the device fleet (``"soa-torch"`` on ``cuda``)
Simulation = functools.partial(Simulation, backend="scalar")


def _run_snaps(wl_name, n_steps=20, cfg=None):
    sim = Simulation([get_workload(wl_name)],
                     configs=[cfg or ClientConfig()], seed=0)
    b = SnapshotBuilder(0.5, 1)
    snaps = []

    def probe(client, t, dt):
        s = b.sample(client.stats, t)
        if s:
            snaps.append(s)

    sim.attach_policy(PerClientPolicy({0: probe}))
    sim.run(n_steps * 0.5)
    return b, snaps


def test_metric_ranges_write():
    _, snaps = _run_snaps("s_wr_sq_1m")
    for s in snaps[2:]:
        m = s.write
        assert 0.0 <= m.rpc_page_util <= 1.5
        assert 0.0 <= m.rpc_channel_util <= 1.5
        assert m.unit_page_latency >= 0.0
        assert m.data_volume >= 0.0
        assert 0.0 <= m.dirty_cache_util <= 1.2


def test_read_workload_has_no_write_activity():
    _, snaps = _run_snaps("s_rd_sq_1m")
    s = snaps[-1]
    assert s.read_active and not s.write_active
    assert s.dominant_op == "read"
    assert s.write.data_volume == 0.0


def test_page_util_reflects_window():
    """Sequential writes fill extents: page_util ~ 1 regardless of window."""
    _, big = _run_snaps("s_wr_sq_16m", cfg=ClientConfig(1024, 8, 2048))
    assert big[-1].write.rpc_page_util > 0.9
    _, rnd = _run_snaps("s_wr_rn_8k", cfg=ClientConfig(1024, 8, 2048))
    assert rnd[-1].write.rpc_page_util < 0.5


def test_est_cache_update_tracks_absorption():
    """Fig 6(d) workload: the estimator sees in-place updates."""
    _, snaps = _run_snaps("s_wr_sq_1m", n_steps=30)
    est = sum(s.write.est_cache_update for s in snaps[5:])
    assert est > 0


def test_feature_vector_layout():
    b, snaps = _run_snaps("s_wr_sq_1m")
    feats = b.feature_vector("write")
    assert feats is not None and feats.shape == (20,)
    # deltas live at [12:18]; config at [18:20]
    assert np.isfinite(feats).all()
    assert feats[18] == np.log2(1024) and feats[19] == np.log2(8)


def test_normalize_features_is_stable():
    raw = np.array([0.5, 0.2, 1e-4, 1e9, 0.3, 0.0] * 2, dtype=np.float32)
    out = normalize_features(raw)
    assert np.isfinite(out).all()
    assert out[2] == np.log10(1e-4) + 7.0


def test_snapshot_perf_signal():
    _, snaps = _run_snaps("s_rd_sq_1m")
    assert snaps[-1].perf("read") > 0
    assert snaps[-1].perf("write") == 0
    assert snaps[-1].perf() == snaps[-1].perf("read")
