"""Workload generators.

Filebench-style micro-workloads (the paper's training + evaluation set,
§IV-B naming convention ``[s|f]_[rd|wr]_[sq|rn]_[8k|1m|16m]``), DLIO-style
deep-learning I/O kernels (Fig 8), and h5bench-style HPC kernels (Table VII).

A workload is a *demand descriptor* per stream: operation mix, access
pattern, request size, think time, working-set geometry, in-place-update
fraction, and burst duty cycle. The PFS model turns demand into achieved
throughput given the client's current tunables and cluster state.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple

from repro_torch.utils.registry import Registry

KiB = 1024
MiB = 1024 * 1024


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    op: str                     # "read" | "write" | "mixed"
    access: str                 # "seq" | "random" | "strided"
    req_bytes: int
    n_streams: int = 1
    file_bytes: int = 1 << 30   # per-stream working set (1 GiB default)
    inplace_frac: float = 0.0   # fraction of write bytes that overwrite
    #                             still-dirty pages (Fig 6(d) mechanism)
    read_frac: float = 0.0      # for op == "mixed"
    think_s: float = 0.0        # per-request app compute time
    duty_cycle: float = 1.0     # fraction of each period with I/O (bursts);
    #                             0.0 = fully idle (replay gap phases)
    period_s: float = 1.0       # burst period
    stride_bytes: int = 0       # for access == "strided": distance between
    #                             consecutive block starts (>= req implied
    #                             by MPI-IO-style non-overlapping blocks)
    seed_phase: int = 0

    def __post_init__(self):
        if self.op not in ("read", "write", "mixed"):
            raise ValueError(f"bad op {self.op}")
        if self.access not in ("seq", "random", "strided"):
            raise ValueError(f"bad access {self.access}")
        if not (0.0 <= self.inplace_frac <= 1.0):
            raise ValueError("inplace_frac in [0,1]")
        if not (0.0 <= self.duty_cycle <= 1.0):
            raise ValueError("duty_cycle in [0,1]")
        if self.stride_bytes < 0:
            raise ValueError("stride_bytes must be >= 0")
        if self.access == "strided" and self.stride_bytes <= 0:
            raise ValueError("strided access needs stride_bytes > 0")

    @property
    def idle(self) -> bool:
        """A pure gap phase (replay traces): never I/O-active."""
        return self.duty_cycle <= 0.0

    def active(self, t: float) -> bool:
        """Is the workload in its I/O-active phase at time t (bursts)?"""
        if self.idle:
            return False
        if self.duty_cycle >= 1.0:
            return True
        return (t % self.period_s) < self.duty_cycle * self.period_s


WORKLOADS: Registry[WorkloadSpec] = Registry("workload")


def _reg(spec: WorkloadSpec) -> WorkloadSpec:
    WORKLOADS.register(spec.name, spec)
    return spec


def get_workload(name: str) -> WorkloadSpec:
    return WORKLOADS.get(name)


# --------------------------------------------------------------------------
# Filebench-style micro-workloads (paper §IV-B).
# Training set = single-stream (s_*); evaluation adds five-stream (f_*).
# Sizes 8 KiB / 1 MiB / 16 MiB; sequential and random; read and write.
# The 1 MiB write workloads carry a heavy in-place-update component — the
# paper calls this out explicitly for Fig 6(d).
# --------------------------------------------------------------------------
_SIZES: Dict[str, int] = {"8k": 8 * KiB, "1m": MiB, "16m": 16 * MiB}

for _streams, _sname in ((1, "s"), (5, "f")):
    for _op, _oname in (("read", "rd"), ("write", "wr")):
        for _acc, _aname in (("seq", "sq"), ("random", "rn")):
            for _size_tag, _bytes in _SIZES.items():
                inplace = 0.0
                if _op == "write" and _size_tag == "1m":
                    inplace = 0.65  # heavy in-place updates (Fig 6(d))
                elif _op == "write" and _acc == "random":
                    inplace = 0.15
                _reg(WorkloadSpec(
                    name=f"{_sname}_{_oname}_{_aname}_{_size_tag}",
                    op=_op,
                    access=_acc,
                    req_bytes=_bytes,
                    n_streams=_streams,
                    file_bytes=(1 << 30) if _bytes <= MiB else (4 << 30),
                    inplace_frac=inplace,
                ))

# --------------------------------------------------------------------------
# DLIO-style DL I/O kernels (Fig 8). Small sample-oriented reads over many
# files, per-epoch shuffling, multi-threaded prefetch => short bursty phases
# that fragment RPC extents (paper §IV-I).
# --------------------------------------------------------------------------
_reg(WorkloadSpec(
    name="dlio_bert",
    op="read",
    access="random",
    req_bytes=160 * KiB,        # BERT sample ~ tfrecord slice
    n_streams=4,                # prefetch threads
    file_bytes=2 << 30,
    duty_cycle=0.45, period_s=2.0,   # compute/IO alternation per batch group
))
_reg(WorkloadSpec(
    name="dlio_megatron",
    op="mixed",
    access="seq",
    req_bytes=2 * MiB,          # indexed-dataset block reads
    read_frac=0.8,              # + periodic checkpoint write share
    n_streams=2,
    file_bytes=8 << 30,
    inplace_frac=0.0,
    duty_cycle=0.6, period_s=4.0,
))

# --------------------------------------------------------------------------
# h5bench-style HPC kernels (Table VII). Regular, well-aligned, large and
# sequential — the regime where Lustre defaults are already near-optimal,
# which the paper uses to show CARAT does no harm.
# --------------------------------------------------------------------------
_reg(WorkloadSpec(
    name="vpic_io",
    op="write",
    access="seq",
    req_bytes=8 * MiB,          # 3D particle array flush
    n_streams=2,
    file_bytes=8 << 30,
))
_reg(WorkloadSpec(
    name="bdcats_io",
    op="read",
    access="seq",
    req_bytes=8 * MiB,
    n_streams=2,
    file_bytes=8 << 30,
))


def filebench_names(streams: str = "s") -> Tuple[str, ...]:
    """All filebench workload names for a stream class ('s' or 'f')."""
    out = []
    for op in ("rd", "wr"):
        for acc in ("sq", "rn"):
            for size in ("8k", "1m", "16m"):
                out.append(f"{streams}_{op}_{acc}_{size}")
    return tuple(out)


def training_workloads() -> Tuple[str, ...]:
    """Paper §IV-B: models are trained on *single-stream* patterns only."""
    return filebench_names("s")


def unseen_workloads() -> Tuple[str, ...]:
    """Five-stream variants — never seen during training (Fig 6 right col)."""
    return filebench_names("f")


def with_streams(spec: WorkloadSpec, n: int) -> WorkloadSpec:
    return replace(spec, n_streams=n, name=f"{spec.name}@{n}")


def idle_workload(name: str = "idle") -> WorkloadSpec:
    """A pure gap phase: no I/O is ever offered, but a client holding dirty
    pages keeps draining them (exactly what a replayed trace gap does — and
    what arms the stage-2 inactive->active boundary)."""
    return WorkloadSpec(name=name, op="read", access="seq",
                        req_bytes=4 * KiB, duty_cycle=0.0)
