"""Trace-driven workload replay: phased schedules drive the simulator.

CARAT's headline claim is *online* adaptivity, so the simulator needs
clients whose behaviour changes over time the way real applications do
(paper §IV Fig 7-8). This module supplies that substrate:

* a **phase-record trace schema** in the spirit of Darshan-DXT / Lustre
  llite stats dumps: each record summarizes one client's I/O over a time
  window — op mix, request size, access pattern (including stride),
  stream count, burst duty;
* a **parser** for the ``carat-trace v1`` text format plus a canonical
  renderer (``parse_trace(render_trace(t)) == t``);
* a **phase segmenter** that merges adjacent similar records into
  phases, turns trace gaps into explicit idle phases, and compiles each
  client's records into a :class:`WorkloadSchedule` — a time-ordered
  sequence of :class:`~repro_torch.storage.workloads.WorkloadSpec`
  phases;
* **replay support**: :func:`simulation_from_schedules` /
  :func:`simulation_from_trace` build a
  :class:`~repro_torch.storage.sim.Simulation` whose steps consult the
  schedules and call ``set_workload`` at phase boundaries — carried
  client state (dirty cache, last observed queue delays, last drain) is
  deliberately preserved across switches, exactly as a real client
  rolls from one application phase into the next;
* a bundled trace corpus (``storage/traces/``) and a deterministic
  **synthetic-trace generator** for property tests.

Everything here is deterministic: the same trace text always compiles
to the identical schedule, and replayed runs inherit the simulator's
seeded reproducibility. The replay builders follow the port's
``Simulation``: ``backend="soa-torch"`` on ``cuda`` unless the caller
passes another backend or ``device="cpu"``.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.device import DeviceLike
from repro_torch.storage.client import ClientConfig
from repro_torch.storage.sim import SchedulePolicy, Simulation
from repro_torch.storage.workloads import (KiB, MiB, WorkloadSpec,
                                           get_workload, idle_workload)
from repro_torch.utils.rng import RngStream

TRACE_MAGIC = "# carat-trace v1"
TRACE_FIELDS = ("client", "t_start", "t_end", "op", "access", "req_bytes",
                "stride_bytes", "streams", "read_frac", "duty_cycle",
                "period_s", "file_bytes", "inplace_frac")

_TRACE_DIR = Path(__file__).parent / "traces"

# single module-level idle spec so ``spec_at`` can return a stable object
# for every out-of-phase instant (the sim's switch check is ``is``-based)
IDLE = idle_workload()


# ---------------------------------------------------------------- records --
@dataclass(frozen=True)
class TraceRecord:
    """One windowed observation of a client's I/O behaviour.

    This is the Darshan-DXT/llite-style unit: not a single operation but
    a short window's summary — which is what client-side counter dumps
    actually provide at probe granularity.
    """
    client: int
    t_start: float
    t_end: float
    op: str                     # "read" | "write" | "mixed"
    access: str                 # "seq" | "random" | "strided"
    req_bytes: int
    stride_bytes: int = 0
    streams: int = 1
    read_frac: float = 0.0
    duty_cycle: float = 1.0
    period_s: float = 1.0
    file_bytes: int = 1 << 30
    inplace_frac: float = 0.0

    def __post_init__(self):
        if self.t_start < 0:
            raise ValueError(f"record window starts at t={self.t_start} < 0 "
                             f"(replay time begins at 0)")
        if self.t_end <= self.t_start:
            raise ValueError(f"record window [{self.t_start}, {self.t_end}] "
                             f"is empty or reversed")
        if self.op not in ("read", "write", "mixed"):
            raise ValueError(f"bad op {self.op!r}")
        if self.access not in ("seq", "random", "strided"):
            raise ValueError(f"bad access {self.access!r}")
        if self.req_bytes <= 0 or self.streams < 1 or self.file_bytes <= 0:
            raise ValueError("req_bytes/streams/file_bytes must be positive")
        if self.access == "strided" and self.stride_bytes < self.req_bytes:
            raise ValueError(f"strided record needs stride_bytes >= "
                             f"req_bytes, got {self.stride_bytes} < "
                             f"{self.req_bytes}")
        for name in ("read_frac", "duty_cycle", "inplace_frac"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} must be in [0,1], got {v}")
        if self.duty_cycle <= 0.0:
            raise ValueError("duty_cycle must be > 0 (gaps are expressed "
                             "by omitting records, not zero-duty ones)")
        if self.period_s <= 0.0:
            raise ValueError("period_s must be > 0")

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


@dataclass(frozen=True)
class Trace:
    """A parsed trace: per-client, time-sorted phase records."""
    name: str
    records: Dict[int, Tuple[TraceRecord, ...]]

    def clients(self) -> List[int]:
        return sorted(self.records)

    @property
    def duration(self) -> float:
        return max((rs[-1].t_end for rs in self.records.values()
                    if rs), default=0.0)

    @property
    def n_records(self) -> int:
        return sum(len(rs) for rs in self.records.values())


# ----------------------------------------------------------------- parsing --
def _fmt(x) -> str:
    """Canonical float form: fixed 3-decimal (ms) grid, zeros stripped —
    exact for arbitrarily long traces, unlike significant-digit formats."""
    if isinstance(x, int):
        return str(x)
    s = f"{float(x):.3f}"
    return s.rstrip("0").rstrip(".")


def parse_trace(text: str, name: str = "trace") -> Trace:
    """Parse ``carat-trace v1`` text into a :class:`Trace`.

    Lines starting with ``#`` and blank lines are comments; the first
    content line must be the field header (fixed order). Records are
    grouped per client, sorted by window start; overlapping windows for
    one client are rejected.
    """
    lines = [ln.strip() for ln in text.splitlines()]
    content = [ln for ln in lines if ln and not ln.startswith("#")]
    if not content:
        raise ValueError(f"{name}: empty trace")
    header = tuple(f.strip() for f in content[0].split(","))
    if header != TRACE_FIELDS:
        raise ValueError(f"{name}: bad header {header}; expected "
                         f"{TRACE_FIELDS}")
    per_client: Dict[int, List[TraceRecord]] = {}
    for lno, ln in enumerate(content[1:], start=2):
        cols = [c.strip() for c in ln.split(",")]
        if len(cols) != len(TRACE_FIELDS):
            raise ValueError(f"{name} row {lno}: {len(cols)} fields, "
                             f"expected {len(TRACE_FIELDS)}")
        try:
            rec = TraceRecord(
                client=int(cols[0]), t_start=float(cols[1]),
                t_end=float(cols[2]), op=cols[3], access=cols[4],
                req_bytes=int(cols[5]), stride_bytes=int(cols[6]),
                streams=int(cols[7]), read_frac=float(cols[8]),
                duty_cycle=float(cols[9]), period_s=float(cols[10]),
                file_bytes=int(cols[11]), inplace_frac=float(cols[12]))
        except ValueError as e:
            raise ValueError(f"{name} row {lno}: {e}") from e
        per_client.setdefault(rec.client, []).append(rec)
    records: Dict[int, Tuple[TraceRecord, ...]] = {}
    for cid, recs in per_client.items():
        recs.sort(key=lambda r: (r.t_start, r.t_end))
        for a, b in zip(recs, recs[1:]):
            if b.t_start < a.t_end - 1e-9:
                raise ValueError(f"{name}: client {cid} windows overlap at "
                                 f"t={b.t_start}")
        records[cid] = tuple(recs)
    return Trace(name=name, records=records)


def render_trace(trace: Trace) -> str:
    """Canonical text form: ``parse_trace(render_trace(t)) == t`` for
    records whose floats sit on the canonical 1 ms / 0.001 grid (true of
    the bundled corpus, ``synthesize_trace`` output, and re-rendered
    parses of such traces); finer-grained values are quantized."""
    out = [TRACE_MAGIC, ",".join(TRACE_FIELDS)]
    for cid in trace.clients():
        for r in trace.records[cid]:
            out.append(",".join([
                _fmt(r.client), _fmt(r.t_start), _fmt(r.t_end), r.op,
                r.access, _fmt(r.req_bytes), _fmt(r.stride_bytes),
                _fmt(r.streams), _fmt(r.read_frac), _fmt(r.duty_cycle),
                _fmt(r.period_s), _fmt(r.file_bytes),
                _fmt(r.inplace_frac)]))
    return "\n".join(out) + "\n"


def load_trace(path) -> Trace:
    p = Path(path)
    return parse_trace(p.read_text(), name=p.stem)


def bundled_traces() -> Tuple[str, ...]:
    """Names of the bundled trace corpus (``load_bundled_trace``)."""
    return tuple(sorted(p.stem for p in _TRACE_DIR.glob("*.trace")))


def load_bundled_trace(name: str) -> Trace:
    path = _TRACE_DIR / f"{name}.trace"
    if not path.exists():
        raise KeyError(f"no bundled trace {name!r}; have {bundled_traces()}")
    return load_trace(path)


# ------------------------------------------------------------- scheduling --
@dataclass(frozen=True)
class SchedulePhase:
    start_s: float
    end_s: float
    spec: WorkloadSpec

    @property
    def duration(self) -> float:
        return self.end_s - self.start_s


@dataclass(frozen=True)
class WorkloadSchedule:
    """Time-ordered workload phases for one client.

    Outside every phase (before the first, inside a hand-built gap,
    after the last) the schedule is idle: ``spec_at`` returns the shared
    :data:`IDLE` spec, which offers no I/O but still lets carried dirty
    pages drain — the mechanism that arms the stage-2 inactive->active
    boundary across replayed gaps.
    """
    client_id: int
    phases: Tuple[SchedulePhase, ...]
    _starts: Tuple[float, ...] = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        for a, b in zip(self.phases, self.phases[1:]):
            if b.start_s < a.end_s - 1e-9:
                raise ValueError(f"client {self.client_id}: phases overlap "
                                 f"at t={b.start_s}")
        object.__setattr__(self, "_starts",
                           tuple(p.start_s for p in self.phases))

    def phase_at(self, t: float) -> Optional[SchedulePhase]:
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self.phases[i].end_s:
            return self.phases[i]
        return None

    def spec_at(self, t: float) -> WorkloadSpec:
        ph = self.phase_at(t)
        return ph.spec if ph is not None else IDLE

    @property
    def boundaries(self) -> Tuple[float, ...]:
        """Times at which the replayed workload changes."""
        out: List[float] = []
        prev_end = None
        for p in self.phases:
            if prev_end is not None and p.start_s > prev_end + 1e-9:
                out.append(prev_end)        # phase -> idle gap
            out.append(p.start_s)
            prev_end = p.end_s
        if prev_end is not None:
            out.append(prev_end)            # trailing edge -> idle
        return tuple(out)

    @property
    def duration(self) -> float:
        return self.phases[-1].end_s if self.phases else 0.0

    def active_phases(self) -> List[SchedulePhase]:
        return [p for p in self.phases if not p.spec.idle]


# ---------------------------------------------------------------- segmenter --
def _size_tag(n: int) -> str:
    if n >= MiB:
        return f"{n // MiB}m" if n % MiB == 0 else f"{n / MiB:.3g}m"
    return f"{n // KiB}k" if n % KiB == 0 else f"{n}b"


def _similar(a: TraceRecord, b: TraceRecord, req_ratio: float,
             duty_tol: float) -> bool:
    """Do two adjacent records describe the same behavioural phase?"""
    if a.op != b.op or a.access != b.access or a.streams != b.streams:
        return False
    lo, hi = sorted((a.req_bytes, b.req_bytes))
    if hi > lo * req_ratio:
        return False
    if a.access == "strided":
        s_lo, s_hi = sorted((a.stride_bytes, b.stride_bytes))
        if s_hi > s_lo * req_ratio:
            return False
    if abs(a.duty_cycle - b.duty_cycle) > duty_tol:
        return False
    if abs(a.read_frac - b.read_frac) > 0.25:
        return False
    return True


def _group_spec(group: Sequence[TraceRecord], name: str) -> WorkloadSpec:
    """Collapse one merged record group into a WorkloadSpec.

    Aggregation is duration-weighted and runs in record order, so the
    same group always produces the identical (float-for-float) spec.
    """
    wts = [r.duration for r in group]
    total = sum(wts)

    def wmean(get):
        return sum(w * get(r) for w, r in zip(wts, group)) / total

    anchor = group[0]
    req = int(round(wmean(lambda r: r.req_bytes)))
    stride = 0
    if anchor.access == "strided":
        stride = max(int(round(wmean(lambda r: r.stride_bytes))), req)
    duty = min(wmean(lambda r: r.duty_cycle), 1.0)
    if duty > 0.999:
        duty = 1.0
    return WorkloadSpec(
        name=f"{name}:{anchor.op}-{anchor.access}-{_size_tag(req)}",
        op=anchor.op,
        access=anchor.access,
        req_bytes=req,
        n_streams=anchor.streams,
        file_bytes=max(r.file_bytes for r in group),
        inplace_frac=wmean(lambda r: r.inplace_frac),
        read_frac=wmean(lambda r: r.read_frac),
        duty_cycle=duty,
        period_s=wmean(lambda r: r.period_s),
        stride_bytes=stride,
    )


def segment_phases(
    records: Sequence[TraceRecord],
    client_id: int,
    name: str = "trace",
    gap_s: float = 1.0,
    req_ratio: float = 2.0,
    duty_tol: float = 0.25,
) -> WorkloadSchedule:
    """Compile one client's records into a phase schedule.

    Adjacent records merge into one phase when they are behaviourally
    similar (same op/access/streams, request sizes within ``req_ratio``,
    duty cycles within ``duty_tol``) and the window gap between them is
    below ``gap_s``. Larger gaps become explicit idle phases; smaller
    gaps are absorbed by extending the earlier phase.
    """
    recs = sorted(records, key=lambda r: (r.t_start, r.t_end))
    if not recs:
        return WorkloadSchedule(client_id=client_id, phases=())
    groups: List[List[TraceRecord]] = [[recs[0]]]
    for r in recs[1:]:
        cur = groups[-1]
        if (r.t_start - cur[-1].t_end < gap_s
                and _similar(cur[0], r, req_ratio, duty_tol)):
            cur.append(r)
        else:
            groups.append([r])

    phases: List[SchedulePhase] = []
    for gi, group in enumerate(groups):
        start, end = group[0].t_start, group[-1].t_end
        if phases:
            gap = start - phases[-1].end_s
            if gap >= gap_s:
                phases.append(SchedulePhase(
                    phases[-1].end_s, start,
                    idle_workload(f"{name}/c{client_id}/gap{gi}")))
            elif gap > 0:
                prev = phases[-1]
                phases[-1] = SchedulePhase(prev.start_s, start, prev.spec)
        elif start > 0:
            phases.append(SchedulePhase(
                0.0, start, idle_workload(f"{name}/c{client_id}/gap0")))
        phases.append(SchedulePhase(
            start, end,
            _group_spec(group, f"{name}/c{client_id}/p{gi}")))
    return WorkloadSchedule(client_id=client_id, phases=tuple(phases))


def compile_trace(trace: Trace, gap_s: float = 1.0, req_ratio: float = 2.0,
                  duty_tol: float = 0.25) -> Dict[int, WorkloadSchedule]:
    """Segment every client's records: client id -> schedule."""
    return {cid: segment_phases(trace.records[cid], cid, name=trace.name,
                                gap_s=gap_s, req_ratio=req_ratio,
                                duty_tol=duty_tol)
            for cid in trace.clients()}


def schedule_from_names(
    names: Sequence[str],
    phase_s: float,
    client_id: int = 0,
    gap_s: float = 0.0,
    start_s: float = 0.0,
) -> WorkloadSchedule:
    """Build a schedule by cycling registry workloads (tests, sweeps)."""
    phases: List[SchedulePhase] = []
    t = start_s
    for i, nm in enumerate(names):
        phases.append(SchedulePhase(t, t + phase_s, get_workload(nm)))
        t += phase_s
        if gap_s > 0 and i < len(names) - 1:
            phases.append(SchedulePhase(
                t, t + gap_s, idle_workload(f"gap{i}")))
            t += gap_s
    return WorkloadSchedule(client_id=client_id, phases=tuple(phases))


# ------------------------------------------------------------------ replay --
def simulation_from_schedules(
    schedules: Mapping[int, WorkloadSchedule],
    params=None,
    configs: Optional[Sequence[ClientConfig]] = None,
    seed: int = 0,
    interval_s: float = 0.5,
    stripe_offsets: Optional[Sequence[int]] = None,
    topology: Optional[Sequence[object]] = None,
    backend: str = "soa-torch",
    device: DeviceLike = None,
) -> Simulation:
    """A Simulation whose clients replay the given phase schedules.

    Clients are created in ascending client-id order with each
    schedule's t=0 spec; every step then consults the schedules, so
    workloads switch exactly at phase boundaries while carried state
    (dirty cache, queue-delay estimates) rolls across the switch.
    """
    ids = sorted(schedules)
    if not ids:
        raise ValueError("need at least one schedule")
    sim = Simulation(
        [schedules[i].spec_at(0.0) for i in ids],
        params=params, configs=configs, seed=seed, interval_s=interval_s,
        stripe_offsets=stripe_offsets, topology=topology, client_ids=ids,
        backend=backend, device=device)
    sim.attach_policy(SchedulePolicy({i: schedules[i] for i in ids}))
    return sim


def simulation_from_trace(trace: Trace, gap_s: float = 1.0, **sim_kw
                          ) -> Tuple[Simulation, Dict[int, WorkloadSchedule]]:
    """Parse nothing, segment, replay: the one-call path for a Trace."""
    schedules = compile_trace(trace, gap_s=gap_s)
    return simulation_from_schedules(schedules, **sim_kw), schedules


# ------------------------------------------------------- synthetic traces --
_SYN_REQ = (8 * KiB, 64 * KiB, 256 * KiB, MiB, 4 * MiB, 16 * MiB)
_SYN_DUTY = (1.0, 1.0, 0.45, 0.6)


def synthesize_trace(
    seed: int,
    n_clients: int = 2,
    duration_s: float = 40.0,
    mean_phase_s: float = 8.0,
    gap_prob: float = 0.3,
    name: Optional[str] = None,
) -> Trace:
    """Deterministic random trace for property tests.

    Each client gets a sequence of behavioural phases; each phase is
    emitted as 1-3 windowed records with request sizes jittered within
    the segmenter's similarity band, so parsing + segmenting a
    synthesized trace exercises real merging. All values are rounded so
    ``render_trace``/``parse_trace`` round-trips exactly.
    """
    rng = RngStream(seed, "syntrace")
    records: Dict[int, Tuple[TraceRecord, ...]] = {}
    for cid in range(n_clients):
        crng = rng.fork(f"c{cid}")
        t = round(float(crng.uniform(0.0, 2.0)), 3)
        recs: List[TraceRecord] = []
        while t < duration_s:
            op = str(crng.choice(["read", "write", "mixed"]))
            access = str(crng.choice(["seq", "random", "strided"]))
            req = int(crng.choice(_SYN_REQ))
            stride = int(req * int(crng.choice([2, 4, 8]))) \
                if access == "strided" else 0
            streams = int(crng.integers(1, 5))
            duty = float(crng.choice(_SYN_DUTY))
            period = round(float(crng.uniform(1.0, 4.0)), 3)
            read_frac = (round(float(crng.uniform(0.2, 0.8)), 3)
                         if op == "mixed" else 0.0)
            inplace = (float(crng.choice([0.0, 0.15, 0.65]))
                       if op in ("write", "mixed") else 0.0)
            phase_s = float(crng.uniform(0.5, 2.0)) * mean_phase_s
            # clamp the final phase so the trace never outruns duration_s
            phase_s = min(phase_s, duration_s - t)
            if phase_s < 1.0:
                break
            n_windows = int(crng.integers(1, 4))
            edges = [t + phase_s * k / n_windows for k in range(n_windows + 1)]
            for a, b in zip(edges, edges[1:]):
                # jitter stays inside the segmenter's similarity band
                # (ratio < 2.0) and below the stride (>= 2x req)
                jitter = float(crng.uniform(0.75, 1.3))
                recs.append(TraceRecord(
                    client=cid, t_start=round(a, 3), t_end=round(b, 3),
                    op=op, access=access,
                    req_bytes=max(int(round(req * jitter)), 1),
                    stride_bytes=stride,
                    streams=streams, read_frac=read_frac, duty_cycle=duty,
                    period_s=period, file_bytes=4 << 30,
                    inplace_frac=inplace))
            t = round(edges[-1], 3)
            if float(crng.uniform()) < gap_prob:
                t = round(t + float(crng.uniform(1.5, 3.0)), 3)
        if recs:
            # a record-less client would be invisible to render_trace and
            # break the round-trip invariant (tiny duration_s + late start)
            records[cid] = tuple(recs)
    return Trace(name=name or f"synthetic-{seed}", records=records)
