"""Linear SVM baseline (paper Table IV).

Squared-hinge loss with L2 regularization, trained by mini-batch SGD with
feature standardization. A Platt-style sigmoid maps margins to the
probability the tuners consume. The simple linear decision boundary is
exactly why the paper finds SVM underfits this problem.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class LinearSVM:
    w: np.ndarray
    b: float
    mu: np.ndarray
    sigma: np.ndarray
    platt_a: float = 1.0
    platt_b: float = 0.0

    def _margin(self, X: np.ndarray) -> np.ndarray:
        Z = (np.asarray(X, np.float32) - self.mu) / self.sigma
        return Z @ self.w + self.b

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        z = self.platt_a * self._margin(X) + self.platt_b
        return 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))

    def predict(self, X: np.ndarray) -> np.ndarray:
        return (self._margin(X) >= 0).astype(np.int32)


def train_svm(
    X: np.ndarray,
    y: np.ndarray,
    c: float = 1.0,
    epochs: int = 60,
    batch: int = 256,
    lr: float = 0.05,
    seed: int = 0,
) -> LinearSVM:
    X = np.asarray(X, np.float32)
    yy = np.where(np.asarray(y) > 0.5, 1.0, -1.0).astype(np.float32)
    mu = X.mean(axis=0)
    sigma = X.std(axis=0) + 1e-6
    Z = (X - mu) / sigma
    n, f = Z.shape
    rng = np.random.Generator(np.random.PCG64(seed))
    w = np.zeros(f, dtype=np.float64)
    b = 0.0
    lam = 1.0 / (c * n)
    for ep in range(epochs):
        order = rng.permutation(n)
        step = lr / (1 + 0.1 * ep)
        for s in range(0, n, batch):
            idx = order[s:s + batch]
            zb, yb = Z[idx], yy[idx]
            margin = zb @ w + b
            viol = np.maximum(0.0, 1.0 - yb * margin)    # squared hinge grad
            gw = lam * w - (2.0 / len(idx)) * ((viol * yb) @ zb)
            gb = -(2.0 / len(idx)) * np.sum(viol * yb)
            w -= step * gw
            b -= step * gb
    # Platt scaling on the training margins
    m = Z @ w + b
    a_, b_ = _platt(m, (yy + 1) / 2)
    return LinearSVM(w=w.astype(np.float32), b=float(b),
                     mu=mu.astype(np.float32), sigma=sigma.astype(np.float32),
                     platt_a=a_, platt_b=b_)


def _platt(margins: np.ndarray, y01: np.ndarray, iters: int = 50):
    a, b = 1.0, 0.0
    for _ in range(iters):
        z = np.clip(a * margins + b, -30, 30)
        p = 1.0 / (1.0 + np.exp(-z))
        g = p - y01
        ga = float(np.mean(g * margins))
        gb = float(np.mean(g))
        h = p * (1 - p)
        ha = float(np.mean(h * margins * margins)) + 1e-6
        hb = float(np.mean(h)) + 1e-6
        a -= ga / ha
        b -= gb / hb
    return a, b
