"""CARAT itself: snapshots, the RPC and cache tuners, the per-client
controller and the fleet policy.

Import from the submodules (``repro_torch.core.policies.carat`` and the
rest). This package file re-exports nothing, so importing a kernel
module never pulls in the policy stack that in turn imports it.
"""
