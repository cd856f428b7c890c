"""Public ops: GBDT probability scoring on a torch device.

``pack_gbdt`` puts a trained :class:`ObliviousGBDT` on a device as the
kernels' operands. ``gbdt_predict_proba`` / :class:`GBDTScorer` score
cross-product rows through ``gbdt_logits``; :class:`GridGBDTScorer` is
the fleet-tuning entry point, scoring a whole node's clients against
the static candidate grid through ``gbdt_grid_logits``.

Every path returns probabilities **bit-identical** to
``ObliviousGBDT.predict_proba``: the kernels (and their plain versions
on the CPU) reproduce ``decision_function``'s float32 summation order,
and the sigmoid runs on the host in NumPy, as in the reference
(``repro/kernels/gbdt_infer/ops.py:273``). A device ``exp`` can differ
from NumPy's by an ulp, and the tau gate and the MinMax ranking of the
tuner turn an ulp into another decision.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.ml.gbdt import ObliviousGBDT, _sigmoid
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gbdt_infer.kernel import (gbdt_grid_logits,
                                                   gbdt_logits)


@dataclass(frozen=True)
class PackedGBDT:
    feat: torch.Tensor    # (T, D) int32 split feature per level
    thr: torch.Tensor     # (T, D) float32 split threshold
    leaf: torch.Tensor    # (T, 2**D) float32 leaf values
    base: float           # initial log-odds, rounded to float32
    n_features: int

    @property
    def device(self) -> torch.device:
        return self.feat.device


def pack_gbdt(model: ObliviousGBDT, device: DeviceLike = None) -> PackedGBDT:
    feat, thr, leaf, base = model.packed()
    if feat.size and not (0 <= feat.min() and feat.max() < model.n_features):
        raise ValueError(f"split features must lie in [0, "
                         f"{model.n_features}), got {feat.min()}.."
                         f"{feat.max()}")
    dev = resolve_device(device)
    return PackedGBDT(
        feat=torch.as_tensor(feat, device=dev),
        thr=torch.as_tensor(thr, device=dev),
        leaf=torch.as_tensor(leaf, device=dev),
        base=float(base[0]),
        n_features=model.n_features)


def _rows_to(X: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(X)).to(device)


def gbdt_predict_proba(packed: PackedGBDT, X: np.ndarray) -> np.ndarray:
    """Probabilities of the (N, F) rows ``X`` (float32 on the host)."""
    X = np.asarray(X, dtype=np.float32)
    if X.ndim != 2 or X.shape[1] != packed.n_features:
        raise ValueError(f"rows must be (N, {packed.n_features}), "
                         f"got {X.shape}")
    logits = gbdt_logits(_rows_to(X, packed.device), packed.feat,
                         packed.thr, packed.leaf, packed.base)
    return _sigmoid(logits.cpu().numpy())


class GBDTScorer:
    """``predict_proba`` adapter: CARAT controller -> ``gbdt_logits``
    (the twin of the reference's ``PallasGBDTScorer``)."""

    def __init__(self, model: ObliviousGBDT, device: DeviceLike = None):
        self.packed = pack_gbdt(model, device)

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return gbdt_predict_proba(self.packed, X)


class GridGBDTScorer:
    """Multi-client batched scorer over a *static* candidate grid.

    Scores ``H`` (n_clients, F_h) snapshot-feature rows against every row
    of a fixed ``theta`` (n_cand, F_t) candidate grid in one call,
    returning (n_clients, n_cand) probabilities — the fleet-tuning hot
    path.

    The model's features are the concatenation [H | theta], so every
    oblivious split tests either a client feature or a candidate feature.
    Because the grid is static, the candidate half of every split is
    evaluated once here at construction (in NumPy, as the reference
    does) and kept on the device as a per-(candidate, tree) partial leaf
    index; per call the kernel evaluates only the client half, adds the
    two (each tree level owns a disjoint bit of the leaf index), gathers
    and sums. ``cfeat``, ``thr``, ``idx_theta`` and ``leaf_flat`` are the
    kernel's model operands (see ``ref.gbdt_grid_logits_ref``).
    """

    def __init__(self, model: ObliviousGBDT, theta: np.ndarray,
                 device: DeviceLike = None):
        self.model = model
        self.theta = np.asarray(theta, dtype=np.float32)
        if self.theta.ndim != 2:
            raise ValueError("theta must be (n_candidates, n_theta_features)")
        n_h = model.n_features - self.theta.shape[1]
        if n_h <= 0:
            raise ValueError(
                f"model consumes {model.n_features} features but the grid "
                f"supplies {self.theta.shape[1]}; no client features left")
        self.n_h = n_h
        self.device = resolve_device(device)
        t, d = model.n_trees, model.depth
        feat = model.feat.reshape(-1).astype(np.int64)
        thr = model.thr.reshape(-1).astype(np.float32)
        is_theta = feat >= n_h
        weights = (1 << np.arange(d - 1, -1, -1)).astype(np.int32)
        # candidate half, evaluated once: per-(tree,level) bits -> per-tree
        # partial leaf index, pre-offset into the flat leaf table
        g_t = self.theta[:, np.where(is_theta, feat - n_h, 0)]
        bits_t = ((g_t > thr) & is_theta).astype(np.int32)
        idx_t = (bits_t.reshape(-1, t, d) * weights).sum(axis=2,
                                                         dtype=np.int32)
        tree_base = np.arange(t, dtype=np.int32) << np.int32(d)
        dev = self.device
        self.idx_theta = torch.as_tensor(
            np.ascontiguousarray(idx_t + tree_base), device=dev)
        self.cfeat = torch.as_tensor(
            np.where(is_theta, -1, feat).reshape(t, d).astype(np.int32),
            device=dev)
        self.thr = torch.as_tensor(thr.reshape(t, d), device=dev)
        self.leaf_flat = torch.as_tensor(
            model.leaf.astype(np.float32).ravel(), device=dev)

    @property
    def n_candidates(self) -> int:
        return self.theta.shape[0]

    def __call__(self, H: np.ndarray) -> np.ndarray:
        """(n, n_cand) probabilities of the (n, F_h) client rows ``H``."""
        H = np.asarray(H, dtype=np.float32)
        if H.ndim == 1:
            H = H[None, :]
        if H.ndim != 2 or H.shape[1] != self.n_h:
            raise ValueError(f"client rows must be (n, {self.n_h}), "
                             f"got {H.shape}")
        logits = gbdt_grid_logits(_rows_to(H, self.device), self.cfeat,
                                  self.thr, self.idx_theta, self.leaf_flat)
        return _sigmoid(self.model.base + logits.cpu().numpy())
