"""CARAT defaults mirroring the paper's Lustre deployment (§IV-A).

- RPC window sizes (``max_pages_per_rpc``): powers of two, 16..1024 pages
  (Lustre default 1024 on the paper's testbed — Table V "Default (1024, 8)").
- RPCs in flight (``max_rpcs_in_flight``): 1..256 (Lustre default 8).
- Dirty cache limit (``max_dirty_mb``): discrete grid, Lustre default 2000 MB
  (2 GB) per OSC; the paper's Algorithm 2 allocates from a bounded grid.
"""
from repro_torch.core.policy import CaratSpaces

SPACES = CaratSpaces(
    rpc_window_pages=(16, 32, 64, 128, 256, 512, 1024),
    rpcs_in_flight=(1, 2, 4, 8, 16, 32, 64, 128, 256),
    dirty_cache_mb=(64, 128, 256, 512, 1024, 2048),
    default_rpc_window=1024,
    default_in_flight=8,
    default_dirty_mb=2048,
)
