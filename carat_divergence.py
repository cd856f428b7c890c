#!/usr/bin/env python3
"""Where CARAT's decisions on the host ``soa`` core and on a second fleet
backend part, on the CPU.

Builds ``chip_smoke.py``'s CARAT scenario (``WL_CYCLE`` clients in nodes
of 16, each flipping its op direction at ``--flip-at`` seconds, the
committed production GBDT pair, ``CaratPolicy`` with its defaults) twice
in one package: once on ``backend="soa"`` and once on the package's
other fleet backend (``soa-torch`` on the CPU for ``repro_torch``,
``soa-jax`` for the reference ``repro``). Both are stepped in lockstep;
after each interval every shell's decisions are compared. At the first
interval where they differ, the script prints the clients that part and,
for the first of them, the paper's dominant-op test (read against write
RPC data volume, ``Snapshot.dominant_op``) on both sides, with each
volume as ``repr`` and the relative gap between them, and the float32
feature rows each side scored (value and bit pattern). At the end it
prints the actuations of each kind on both sides.

Usage (CPU; ~40 s per package at 4096 clients)::

    PYTHONPATH=src python3 carat_divergence.py --package repro_torch
    PYTHONPATH=src python3 carat_divergence.py --package repro

Prints one JSON object.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import OP_FLIP, WL_CYCLE  # noqa: E402

ASSETS = ROOT / "src" / "repro_torch" / "assets"
OTHER = {"repro_torch": "soa-torch", "repro": "soa-jax"}


class _Flip:
    def __init__(self, before, after, at: float):
        self.before, self.after, self.at = before, after, at
        self.boundaries = (at,)

    def spec_at(self, t: float):
        return self.before if t < self.at else self.after


class _ShellProbe:
    """Stands in for a shell's tuner: keeps the last bootstrap row."""

    def __init__(self, inner, log: dict, cid: int):
        self.inner, self.log, self.cid = inner, log, cid

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _probs(self, op, feats):
        self.log[self.cid] = (op, np.asarray(feats, dtype=np.float32))
        return self.inner._probs(op, feats)


def scenario(pkg: str, backend: str, n: int, seed: int, node_size: int,
             flip_at: float):
    storage = importlib.import_module(f"{pkg}.storage")
    carat = importlib.import_module(f"{pkg}.core.policies.carat")
    gbdt = importlib.import_module(f"{pkg}.core.ml.gbdt")
    spaces = importlib.import_module(f"{pkg}.configs.carat_defaults").SPACES
    config = importlib.import_module(f"{pkg}.config").CaratConfig

    def load(op):
        z = np.load(ASSETS / f"gbdt_{op}_s0.npz")
        return gbdt.ObliviousGBDT(feat=z["feat"], thr=z["thr"],
                                  leaf=z["leaf"], base=float(z["base"][0]),
                                  n_features=int(z["n_features"][0]))

    names = [WL_CYCLE[i % len(WL_CYCLE)] for i in range(n)]
    kw = {"device": "cpu"} if backend == "soa-torch" else {}
    sim = storage.Simulation([storage.get_workload(nm) for nm in names],
                             seed=seed, backend=backend,
                             topology=[i // node_size for i in range(n)],
                             **kw)
    sim.attach_policy(storage.SchedulePolicy({
        c.client_id: _Flip(storage.get_workload(nm),
                           storage.get_workload(OP_FLIP[nm]), flip_at)
        for c, nm in zip(sim.clients, names)}))
    pkw = {"device": "cpu"} if pkg == "repro_torch" else {}
    policy = carat.CaratPolicy(spaces, {"read": load("read"),
                                        "write": load("write")},
                               config(), **pkw)
    sim.attach_policy(policy)
    snaps, rows = {}, {}
    for ctrl in policy.controllers:
        sample = ctrl.builder.sample

        def kept(stats, t, sample=sample, cid=ctrl.client_id):
            snaps[cid] = snap = sample(stats, t)
            return snap

        ctrl.builder.sample = kept
        ctrl.tuner = _ShellProbe(ctrl.tuner, rows, ctrl.client_id)
    return sim, policy, snaps, rows


def kinds(policy) -> dict:
    out: dict = {}
    for ctrl in policy.controllers:
        for d in ctrl.decisions:
            k = d[1] if d[1] in ("reprobe", "bootstrap") else "tuned"
            out[k] = out.get(k, 0) + 1
    return out


def side(snap, row) -> dict:
    rd, wr = snap.read.data_volume, snap.write.data_volume
    out = {"read_data_volume": repr(rd), "write_data_volume": repr(wr),
           "dominant_op": snap.dominant_op,
           "volume_rel_gap": abs(rd - wr) / max(abs(rd), abs(wr), 1e-300)}
    if row is not None:
        out["scored_op"] = row[0]
        out["features"] = row[1].tolist()
        out["feature_bits"] = row[1].view(np.uint32).tolist()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=sorted(OTHER), default="repro_torch")
    ap.add_argument("--clients", type=int, default=4096)
    ap.add_argument("--intervals", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--node-size", type=int, default=16)
    ap.add_argument("--flip-at", type=float, default=5.0)
    a = ap.parse_args()
    backends = ("soa", OTHER[a.package])
    runs = {b: scenario(a.package, b, a.clients, a.seed, a.node_size,
                        a.flip_at) for b in backends}
    first = None
    for k in range(a.intervals):
        for sim, _, _, rows in runs.values():
            rows.clear()
            sim.step()
        if first is not None:
            continue
        pols = [runs[b][1] for b in backends]
        parted = [c0.client_id for c0, c1 in zip(pols[0].controllers,
                                                  pols[1].controllers)
                  if c0.decisions != c1.decisions]
        if parted:
            cid = parted[0]
            first = {
                "interval": k, "t": runs[backends[0]][0].t,
                "clients_parted": len(parted), "first_clients": parted[:8],
                "client": cid,
                "workload": WL_CYCLE[cid % len(WL_CYCLE)],
                **{b: {"decision": list(runs[b][1]._shell(cid).decisions[-1]),
                       **side(runs[b][2][cid], runs[b][3].get(cid))}
                   for b in backends}}
            first["ties_among_parted"] = sum(
                runs[backends[0]][2][c].dominant_op
                != runs[backends[1]][2][c].dominant_op for c in parted)
    print(json.dumps({"package": a.package, "clients": a.clients,
                      "intervals": a.intervals, "first_parting": first,
                      "actuations": {b: kinds(runs[b][1])
                                     for b in backends}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
