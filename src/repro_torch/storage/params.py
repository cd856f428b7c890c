"""Physical constants of the modeled PFS deployment.

Calibrated to the paper's CloudLab c6525-25g testbed (Table III): 25 GbE
NICs, SATA-SSD OSTs (two per OSS), 4 OSS nodes => 8 OSTs, 5 clients.
"""
from __future__ import annotations

from dataclasses import dataclass

PAGE_SIZE = 4096  # Lustre client page size (bytes)


@dataclass(frozen=True)
class PFSParams:
    n_osts: int = 8                   # 4 OSS x 2 OSTs (paper testbed)
    # --- network -------------------------------------------------------------
    net_rtt_s: float = 200e-6         # client<->OSS round trip
    nic_bw: float = 3.0e9             # 25 GbE ~ 3 GB/s usable per client node
    ost_ingress_bw: float = 2.8e9     # per-OSS network ceiling
    # --- OST service ---------------------------------------------------------
    ost_disk_bw: float = 450e6        # SATA SSD sustained, per OST
    ssd_qd_half: float = 3.0          # SSD bandwidth reaches disk_bw only at
    #                                   queue depth: bw_eff = bw*QD/(QD+half).
    #                                   Makes in-flight concurrency a real
    #                                   lever (Table V: (64,256) >> (1024,8))
    ost_fixed_cpu_s: float = 250e-6   # fixed per-RPC server cost (queueing,
    #                                   bulk setup, commit) — what makes many
    #                                   small RPCs expensive (§II-A b)
    ost_overload_knee: int = 192      # in-flight RPCs/OST before thrashing
    ost_overload_gamma: float = 0.5   # fixed-cost inflation slope past knee
    queue_wait_cap_s: float = 0.080   # max modeled queue delay
    queue_smoothing: float = 0.5      # EMA carry of per-OST queue delay
    # --- client --------------------------------------------------------------
    mem_bw: float = 8.0e9             # page-copy bandwidth into cache
    syscall_s: float = 4e-6           # per-request syscall overhead
    extent_timeout_s: float = 0.100   # kernel wait threshold for partial
    #                                   extents (§II-A dispatch rule 2)
    frag_overhead: float = 0.25       # grant-space reserved per open extent,
    #                                   as a fraction of the full extent —
    #                                   models cache fragmentation (§II-A a)
    readahead_bytes: float = 64e6     # per-file readahead window (bytes) —
    #                                   outstanding read RPCs = RA/rpc_bytes,
    #                                   so smaller RPCs pipeline deeper
    ra_misfire_frac: float = 0.3      # on random access, probability a
    #                                   readahead misfire drags a full-window
    #                                   transfer in front of the demand read
    extent_scan_bw: float = 4.0e9     # writeback thread scan rate over a
    #                                   partial extent's window (grant walk)
    #                                   — large windows + underfilled extents
    #                                   throttle RPC formation (§II-A a)
    # --- noise ---------------------------------------------------------------
    noise_sigma: float = 0.04         # lognormal service-time jitter / interval

    @property
    def page(self) -> int:
        return PAGE_SIZE
