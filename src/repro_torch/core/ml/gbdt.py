"""Gradient-boosted decision trees, from scratch (paper's winning model).

We use *oblivious* trees (one (feature, threshold) split per level, shared
across the whole level, CatBoost-style):

* training stays a simple histogram scan with Newton leaf values;
* inference is branch-free — a candidate's leaf index is a bit-pack of
  level comparisons — so the same flat (feat, thr, leaf) arrays drive the
  plain torch version and the CUDA kernels of
  :mod:`repro_torch.kernels.gbdt_infer`.

Loss: logistic. Per round: g = p - y, h = p(1-p); leaf value
-sum(g)/(sum(h)+lambda) * lr. Split gain is the standard Newton gain summed
over all current leaves (the split is shared level-wide).

Persistence (:func:`save_gbdt` / :func:`load_gbdt`) uses the reference's
``.npz`` format (``repro/core/ml/train.py``); the seed-0 production pair
ships with the package (:func:`default_models`), so a machine without the
training cache still scores with the real models.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ASSETS = Path(__file__).resolve().parents[2] / "assets"


def _sigmoid(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))


@dataclass
class ObliviousGBDT:
    feat: np.ndarray      # (n_trees, depth) int32 — split feature per level
    thr: np.ndarray       # (n_trees, depth) float32 — split threshold
    leaf: np.ndarray      # (n_trees, 2**depth) float32 — leaf log-odds deltas
    base: float           # initial log-odds
    n_features: int

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]

    @property
    def depth(self) -> int:
        return self.feat.shape[1]

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float32)
        n = X.shape[0]
        # (n, T, D): comparison bits per level
        gathered = X[:, self.feat.reshape(-1)].reshape(n, self.n_trees, self.depth)
        bits = (gathered > self.thr[None, :, :]).astype(np.int64)
        weights = (1 << np.arange(self.depth - 1, -1, -1)).astype(np.int64)
        idx = (bits * weights).sum(axis=2)                      # (n, T)
        # Flat C-contiguous gather, then a row-local pairwise sum over trees.
        # This accumulation order is the contract the kernels and their
        # plain versions (kernels/gbdt_infer) reproduce bit-for-bit; keep
        # them in sync if either changes.
        flat = idx + (np.arange(self.n_trees, dtype=np.int64) << self.depth)
        contrib = self.leaf.ravel().take(flat)
        return self.base + contrib.sum(axis=1)

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return _sigmoid(self.decision_function(X))

    def predict(self, X: np.ndarray) -> np.ndarray:
        return (self.predict_proba(X) >= 0.5).astype(np.int32)

    # ---- packing for the kernels -----------------------------------------------
    def packed(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(feat int32 (T,D), thr f32 (T,D), leaf f32 (T,2^D), base f32 (1,))"""
        return (self.feat.astype(np.int32), self.thr.astype(np.float32),
                self.leaf.astype(np.float32),
                np.array([self.base], dtype=np.float32))


def _bin_features(X: np.ndarray, n_bins: int) -> Tuple[np.ndarray, np.ndarray]:
    """Quantile-bin features. Returns (binned uint8 (n,f), edges (f, n_bins-1))."""
    n, f = X.shape
    edges = np.empty((f, n_bins - 1), dtype=np.float32)
    binned = np.empty((n, f), dtype=np.uint8)
    qs = np.linspace(0, 100, n_bins + 1)[1:-1]
    for j in range(f):
        e = np.unique(np.percentile(X[:, j], qs).astype(np.float32))
        if e.size == 0:
            e = np.array([0.0], dtype=np.float32)
        pad = np.full(n_bins - 1 - e.size, np.float32(np.inf))
        edges[j] = np.concatenate([e, pad])
        binned[:, j] = np.searchsorted(e, X[:, j], side="right").astype(np.uint8)
    return binned, edges


def train_gbdt(
    X: np.ndarray,
    y: np.ndarray,
    n_trees: int = 200,
    depth: int = 4,
    learning_rate: float = 0.1,
    reg_lambda: float = 1.0,
    n_bins: int = 64,
    min_child_hess: float = 1.0,
    subsample: float = 0.8,
    seed: int = 0,
    X_val: Optional[np.ndarray] = None,
    y_val: Optional[np.ndarray] = None,
    early_stopping_rounds: int = 30,
) -> ObliviousGBDT:
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    n, f = X.shape
    rng = np.random.Generator(np.random.PCG64(seed))

    binned, edges = _bin_features(X, n_bins)
    pos = float(y.mean())
    base = float(np.log(max(pos, 1e-6) / max(1 - pos, 1e-6)))
    F = np.full(n, base, dtype=np.float64)

    feats = np.zeros((n_trees, depth), dtype=np.int32)
    thrs = np.zeros((n_trees, depth), dtype=np.float32)
    leaves = np.zeros((n_trees, 1 << depth), dtype=np.float32)

    best_val = np.inf
    best_t = n_trees
    val_F = None
    if X_val is not None:
        val_F = np.full(len(X_val), base, dtype=np.float64)

    for t in range(n_trees):
        p = _sigmoid(F)
        g = (p - y).astype(np.float64)
        h = (p * (1 - p)).astype(np.float64) + 1e-12
        if subsample < 1.0:
            mask = rng.random(n) < subsample
        else:
            mask = np.ones(n, dtype=bool)
        gm = np.where(mask, g, 0.0)
        hm = np.where(mask, h, 0.0)

        idx = np.zeros(n, dtype=np.int64)   # current leaf of each sample
        for level in range(depth):
            n_leaves = 1 << level
            # histograms over (leaf, feature, bin)
            best_gain, best_f, best_b = -1e30, 0, 0
            for j in range(f):
                code = (idx * n_bins) + binned[:, j]
                gh = np.bincount(code, weights=gm, minlength=n_leaves * n_bins)
                hh = np.bincount(code, weights=hm, minlength=n_leaves * n_bins)
                gh = gh.reshape(n_leaves, n_bins)
                hh = hh.reshape(n_leaves, n_bins)
                gl = np.cumsum(gh, axis=1)[:, :-1]       # left sums per split
                hl = np.cumsum(hh, axis=1)[:, :-1]
                gt = gh.sum(axis=1, keepdims=True)
                ht = hh.sum(axis=1, keepdims=True)
                gr = gt - gl
                hr = ht - hl
                ok = (hl >= min_child_hess) & (hr >= min_child_hess)
                gain = (gl ** 2 / (hl + reg_lambda)
                        + gr ** 2 / (hr + reg_lambda)
                        - gt ** 2 / (ht + reg_lambda))
                gain = np.where(ok, gain, -1e30).sum(axis=0)   # shared split
                b = int(np.argmax(gain))
                if gain[b] > best_gain:
                    best_gain, best_f, best_b = float(gain[b]), j, b
            feats[t, level] = best_f
            thr = edges[best_f, best_b] if best_b < edges.shape[1] else np.inf
            thrs[t, level] = thr
            idx = idx * 2 + (binned[:, best_f] > best_b).astype(np.int64)

        # Newton leaf values (on the subsample), applied to all rows
        n_leaf = 1 << depth
        gsum = np.bincount(idx, weights=gm, minlength=n_leaf)
        hsum = np.bincount(idx, weights=hm, minlength=n_leaf)
        vals = (-gsum / (hsum + reg_lambda)) * learning_rate
        leaves[t] = vals.astype(np.float32)
        F += vals[idx]

        if X_val is not None:
            model_t = ObliviousGBDT(feats[t:t + 1], thrs[t:t + 1],
                                    leaves[t:t + 1], 0.0, f)
            val_F += model_t.decision_function(X_val)
            pv = _sigmoid(val_F)
            loss = -np.mean(y_val * np.log(pv + 1e-9)
                            + (1 - y_val) * np.log(1 - pv + 1e-9))
            if loss < best_val - 1e-5:
                best_val, best_t = loss, t + 1
            elif t + 1 - best_t >= early_stopping_rounds:
                break

    used = best_t if X_val is not None else t + 1
    return ObliviousGBDT(feat=feats[:used], thr=thrs[:used],
                         leaf=leaves[:used], base=base, n_features=f)


# ---------------------------------------------------------------- persistence
def save_gbdt(model: ObliviousGBDT, path: str) -> None:
    """Write ``model`` in the reference's ``.npz`` format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, feat=model.feat, thr=model.thr, leaf=model.leaf,
             base=np.array([model.base]), n_features=np.array([model.n_features]))


def load_gbdt(path: str) -> ObliviousGBDT:
    z = np.load(path)
    return ObliviousGBDT(feat=z["feat"], thr=z["thr"], leaf=z["leaf"],
                         base=float(z["base"][0]),
                         n_features=int(z["n_features"][0]))


def gbdt_from_reference(feat: np.ndarray, thr: np.ndarray, leaf: np.ndarray,
                        base: float, n_features: int) -> ObliviousGBDT:
    """Carry a reference model's weights across (as plain arrays, so the
    port never imports the reference package)."""
    return ObliviousGBDT(feat=np.array(feat, dtype=np.int32),
                         thr=np.array(thr, dtype=np.float32),
                         leaf=np.array(leaf, dtype=np.float32),
                         base=float(base), n_features=int(n_features))


def default_models(seed: int = 0) -> Tuple[ObliviousGBDT, ObliviousGBDT]:
    """The committed read/write production pair (the reference's
    ``get_default_models(seed=0)``, paper §IV-B protocol)."""
    return (load_gbdt(str(ASSETS / f"gbdt_read_s{seed}.npz")),
            load_gbdt(str(ASSETS / f"gbdt_write_s{seed}.npz")))
