"""Training-data collection (paper §IV-B).

The paper trains on the *simplest* workloads — single-stream Filebench
patterns — with random adjustments of the tunables after each probe, then
labels each sample by whether the next interval improved by > 15%. We do
exactly that against the PFS model: a data-collection controller applies a
random (window, in_flight) — and occasionally a random cache limit — every
interval and logs (H_t features, theta applied) -> label.

Every sweep simulation runs on the host ``"scalar"`` backend, as the
reference's do: a sweep is thousands of one- and two-client runs, which
the device fleet would only slow down, and the fleet backends' sums are
associated differently, so a read/write tie in ``Snapshot.dominant_op``
could label a sample otherwise. On ``"scalar"`` the samples equal the
reference's bit for bit.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policies.local import PerClientPolicy
from repro_torch.core.policy import CaratSpaces, default_spaces
from repro_torch.core.snapshot import FEATURE_DIM, THETA_DIM, SnapshotBuilder
from repro_torch.storage.client import ClientConfig, IOClient
from repro_torch.storage.params import PFSParams
from repro_torch.storage.replay import (WorkloadSchedule, schedule_from_names,
                                  simulation_from_schedules)
from repro_torch.storage.sim import SchedulePolicy, Simulation
from repro_torch.storage.workloads import get_workload, training_workloads
from repro_torch.utils.logging import get_logger
from repro_torch.utils.rng import RngStream

log = get_logger("core.ml.dataset")


@dataclass
class TrainingData:
    X_read: np.ndarray
    y_read: np.ndarray
    X_write: np.ndarray
    y_write: np.ndarray

    def split(self, frac: float = 0.8, seed: int = 0):
        """80:20 train/validation split per the paper (§IV-C)."""
        rng = np.random.Generator(np.random.PCG64(seed))
        out = []
        for X, y in ((self.X_read, self.y_read), (self.X_write, self.y_write)):
            idx = rng.permutation(len(X))
            cut = int(len(X) * frac)
            out.append((X[idx[:cut]], y[idx[:cut]],
                        X[idx[cut:]], y[idx[cut:]]))
        return out  # [(Xtr,ytr,Xva,yva)_read, (...)_write]


class _Collector:
    """Controller that randomly actuates and logs labeled samples."""

    def __init__(self, spaces: CaratSpaces, interval_s: float,
                 improve_eps: float, rng: RngStream,
                 tune_cache_prob: float = 0.1,
                 hold_prob: float = 0.4):
        self.spaces = spaces
        self.eps = improve_eps
        self.rng = rng
        self.builder = SnapshotBuilder(interval_s=interval_s, history_k=1)
        self.tune_cache_prob = tune_cache_prob
        # with hold_prob the current config is kept for another interval —
        # covers the stable states the online tuner actually sees (and
        # labels "no change" transitions, usually 0)
        self.hold_prob = hold_prob
        self.pending: Dict[str, Optional[Tuple[np.ndarray, float]]] = {
            "read": None, "write": None}
        self.rows: Dict[str, List[Tuple[np.ndarray, int]]] = {
            "read": [], "write": []}

    def __call__(self, client: IOClient, t: float, dt: float) -> None:
        snap = self.builder.sample(client.stats, t)
        if snap is None:
            return
        for op in ("read", "write"):
            perf_now = snap.perf(op)
            pend = self.pending[op]
            if pend is not None:
                x_row, perf_before = pend
                if perf_before > 0:          # paper keeps non-zero samples
                    improved = perf_now / perf_before > (1.0 + self.eps)
                    self.rows[op].append((x_row, int(improved)))
                self.pending[op] = None

        # pick and apply a random theta for the *next* interval
        feats = {op: self.builder.feature_vector(op) for op in ("read", "write")}
        cands = self.spaces.rpc_candidates()
        if float(self.rng.uniform()) < self.hold_prob:
            w, f = client.config.rpc_window_pages, client.config.rpcs_in_flight
        else:
            w, f = cands[int(self.rng.integers(0, len(cands)))]
        if float(self.rng.uniform()) < self.tune_cache_prob:
            grid = self.spaces.dirty_cache_mb
            client.set_cache_limit(int(grid[int(self.rng.integers(0, len(grid)))]))
        theta = np.array([np.log2(w), np.log2(f)], dtype=np.float32)
        for op in ("read", "write"):
            if feats[op] is not None and snap.perf(op) > 0:
                x_row = np.concatenate([feats[op], theta])
                self.pending[op] = (x_row, snap.perf(op))
        client.set_rpc_config(w, f)


def _stack_rows(rows: Dict[str, List[Tuple[np.ndarray, int]]]) -> TrainingData:
    def _stack(op):
        if not rows[op]:
            dim = FEATURE_DIM + THETA_DIM
            return (np.zeros((0, dim), np.float32), np.zeros((0,), np.int32))
        X = np.stack([r[0] for r in rows[op]]).astype(np.float32)
        y = np.array([r[1] for r in rows[op]], dtype=np.int32)
        return X, y

    Xr, yr = _stack("read")
    Xw, yw = _stack("write")
    return TrainingData(X_read=Xr, y_read=yr, X_write=Xw, y_write=yw)


def collect_training_data(
    workload_names: Optional[Sequence[str]] = None,
    reps: int = 6,
    duration_s: float = 60.0,
    interval_s: float = 0.5,
    improve_eps: float = 0.15,
    spaces: Optional[CaratSpaces] = None,
    params: Optional[PFSParams] = None,
    seed: int = 0,
    ambient_frac: float = 0.33,
    phased_frac: float = 0.0,
    phase_gap_s: float = 2.0,
) -> TrainingData:
    """ambient_frac of the reps run with an uncontrolled background client
    on an overlapping OST — the tuned client still observes ONLY its local
    metrics, but the sweep then covers contended server states the way the
    paper's shared testbed naturally did. Without this, the model never
    sees high-latency/low-grant states and stays silent under interference
    (paper §IV-H).

    phased_frac of the reps replace the static workload with a replayed
    multi-phase schedule (three sweep workloads back-to-back with idle
    gaps, `repro_torch.storage.replay`), so the sweep also labels the
    phase-transition states an online deployment actually tunes through —
    the dynamic-pattern regime of Fig 7. Default 0.0 keeps the paper's
    single-stream protocol (and the cached default models) unchanged."""
    spaces = spaces or default_spaces()
    names = list(workload_names or training_workloads())
    rows: Dict[str, List[Tuple[np.ndarray, int]]] = {"read": [], "write": []}
    root = RngStream(seed, "collect")
    ambient_pool = ["s_wr_sq_16m", "s_rd_sq_1m", "s_wr_rn_1m", "s_rd_sq_16m"]

    def _cadence(frac, rep, offset):
        if frac <= 0:
            return False
        k = max(int(round(1 / frac)), 1)
        return rep % k == offset % k

    for rep in range(reps):
        ambient = _cadence(ambient_frac, rep, 1)
        phased = _cadence(phased_frac, rep, 2)
        for wi, name in enumerate(names):
            wl = get_workload(name)
            # stable per-workload seed (hash() is process-randomized)
            name_h = int.from_bytes(
                hashlib.sha256(name.encode()).digest()[:4], "little")
            sim_seed = seed * 1000 + rep * 37 + name_h % 997
            if ambient:
                noise = get_workload(ambient_pool[(rep + wi)
                                                  % len(ambient_pool)])
                sim = Simulation([wl, noise], params=params,
                                 configs=[ClientConfig(), ClientConfig()],
                                 seed=sim_seed,
                                 interval_s=interval_s,
                                 stripe_offsets=[0, 0],
                                 backend="scalar")
            else:
                sim = Simulation([wl], params=params,
                                 configs=[ClientConfig()],
                                 seed=sim_seed,
                                 interval_s=interval_s,
                                 backend="scalar")
            if phased:
                # replayed multi-phase rep: this workload then two sweep
                # neighbours, separated by boundary-arming idle gaps
                rot = [names[(wi + k) % len(names)] for k in range(3)]
                n_gaps = len(rot) - 1
                phase_s = max((duration_s - n_gaps * phase_gap_s)
                              / len(rot), 2 * interval_s)
                sim.attach_policy(SchedulePolicy({0: schedule_from_names(
                    rot, phase_s=phase_s, gap_s=phase_gap_s)}))
            coll = _Collector(spaces, interval_s, improve_eps,
                              root.fork(f"{name}/{rep}"))
            sim.attach_policy(PerClientPolicy({0: coll}))
            sim.run(duration_s)
            for op in ("read", "write"):
                rows[op].extend(coll.rows[op])
    log.info("collected %d read / %d write samples",
             len(rows["read"]), len(rows["write"]))
    return _stack_rows(rows)


def collect_replayed_data(
    schedules: Mapping[int, WorkloadSchedule],
    reps: int = 4,
    duration_s: Optional[float] = None,
    interval_s: float = 0.5,
    improve_eps: float = 0.15,
    spaces: Optional[CaratSpaces] = None,
    params: Optional[PFSParams] = None,
    seed: int = 0,
) -> TrainingData:
    """Labeled samples from replayed phase schedules (bundled trace corpus
    or `synthesize_trace` output): every scheduled client gets its own
    random-actuation collector and the whole schedule set replays
    together, so samples cover phase transitions AND the cross-client
    contention the trace encodes."""
    spaces = spaces or default_spaces()
    if duration_s is None:
        duration_s = max(s.duration for s in schedules.values())
    rows: Dict[str, List[Tuple[np.ndarray, int]]] = {"read": [], "write": []}
    root = RngStream(seed, "collect-replay")
    for rep in range(reps):
        sim = simulation_from_schedules(
            schedules, params=params, seed=seed * 1000 + rep * 41,
            interval_s=interval_s, backend="scalar")
        colls = {}
        for cid in sorted(schedules):
            colls[cid] = _Collector(spaces, interval_s, improve_eps,
                                    root.fork(f"c{cid}/{rep}"))
        sim.attach_policy(PerClientPolicy(colls))
        sim.run(duration_s)
        for coll in colls.values():
            for op in ("read", "write"):
                rows[op].extend(coll.rows[op])
    log.info("collected %d read / %d write replayed samples",
             len(rows["read"]), len(rows["write"]))
    return _stack_rows(rows)
