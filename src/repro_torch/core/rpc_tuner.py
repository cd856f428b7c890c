"""RPC parameter tuners (paper §III-D, Algorithm 1).

Three strategies, in the order the paper developed them:

* ``GreedyTuner`` — argmax model probability. Safe but conservative: high
  probability does not mean high gain.
* ``EpsilonGreedyTuner`` — greedy + epsilon random exploration. Better
  asymptotically but slow and high-variance online.
* ``ConditionalScoreGreedy`` — the paper's contribution: tau-filter the
  candidates by probability, MinMax-normalize the retained set, then rank
  by a score that biases toward "progressive" configurations:
      WriteScore(theta) = f(theta,H) * (1 + beta * sum(theta_norm))
      ReadScore(theta)  = f(theta,H) * (1 + alpha * theta_norm[0]) + theta_norm[1]
  with alpha = beta = 0.5 (paper's balanced gain-stability tradeoff).

A tuner proposes ``(window_pages, in_flight)`` or None (retain current —
the stability gate of §III-F when no candidate clears tau).

Two entry points share each strategy's selection rule:

* ``propose(op, feats)`` — the scalar per-client path;
* ``propose_many(ops, feats, rngs)`` — the fleet path: one vectorized
  inference call over every pending client (grouped by op direction) and
  a vectorized per-client selection. Decisions are bit-identical to
  calling ``propose`` per client, provided the model scores rows
  batch-invariantly (true of the GBDT paths; exploration draws are taken
  from each client's own RngStream in client order).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import CaratSpaces
from repro_torch.telemetry import perf_s
from repro_torch.utils.rng import RngStream

# A scorer maps a batch of rows (n_candidates, n_features) -> probabilities.
ProbFn = Callable[[np.ndarray], np.ndarray]
# A grid scorer maps (n_clients, n_features) -> (n_clients, n_candidates).
GridProbFn = Callable[[np.ndarray], np.ndarray]


class _TunerBase:
    def __init__(
        self,
        spaces: CaratSpaces,
        models: Dict[str, ProbFn],          # "read"/"write" -> predict_proba
        tau: float = 0.8,
        alpha: float = 0.5,
        beta: float = 0.5,
        rng: Optional[RngStream] = None,
        grid_models: Optional[Dict[str, GridProbFn]] = None,
    ):
        self.spaces = spaces
        self.models = models
        self.tau = tau
        self.alpha = alpha
        self.beta = beta
        self.rng = rng or RngStream(0, "tuner")
        self.grid_models = grid_models or {}
        self._cands = spaces.rpc_candidates()
        self._theta = spaces.theta_features()          # (n, 2) log2 scale
        # Table VIII accounting
        self.inference_time_total = 0.0
        self.tune_time_total = 0.0
        self.tune_count = 0

    # ------------------------------------------------------------------ hooks
    def _probs(self, op: str, feats: np.ndarray) -> np.ndarray:
        X = np.concatenate(
            [np.broadcast_to(feats, (len(self._cands), feats.shape[0])),
             self._theta], axis=1).astype(np.float32)
        t0 = perf_s()
        probs = np.asarray(self.models[op](X), dtype=np.float64).reshape(-1)
        self.inference_time_total += perf_s() - t0
        return probs

    def _probs_many(self, op: str, feats: np.ndarray) -> np.ndarray:
        """(k, n_features) client rows -> (k, n_candidates) probabilities."""
        k = feats.shape[0]
        grid = self.grid_models.get(op)
        if grid is not None:
            return np.asarray(grid(feats), dtype=np.float64).reshape(k, -1)
        c = len(self._cands)
        X = np.concatenate([np.repeat(feats, c, axis=0),
                            np.tile(self._theta, (k, 1))],
                           axis=1).astype(np.float32)
        return np.asarray(self.models[op](X), dtype=np.float64).reshape(k, c)

    def _select(self, op: str, probs: np.ndarray,
                rng: Optional[RngStream] = None) -> Optional[int]:
        raise NotImplementedError

    def _select_many(self, ops: Sequence[str], probs: np.ndarray,
                     rngs: Optional[Sequence[RngStream]] = None) -> np.ndarray:
        """Default batched selection: per-row ``_select`` (strategies with a
        closed-form vectorization override this). Returns (k,) candidate
        indices with -1 encoding "retain current config"."""
        out = np.empty(len(ops), dtype=np.int64)
        for i, op in enumerate(ops):
            k = self._select(op, probs[i],
                             rng=rngs[i] if rngs is not None else None)
            out[i] = -1 if k is None else k
        return out

    # ------------------------------------------------------------------ API
    def propose(self, op: str, feats: np.ndarray) -> Optional[Tuple[int, int]]:
        t0 = perf_s()
        probs = self._probs(op, feats)
        k = self._select(op, probs)
        self.tune_time_total += perf_s() - t0
        self.tune_count += 1
        if k is None:
            return None
        return self._cands[k]

    def propose_many(
        self,
        ops: Sequence[str],
        feats: np.ndarray,
        rngs: Optional[Sequence[RngStream]] = None,
    ) -> List[Optional[Tuple[int, int]]]:
        """Batched Stage-1 tuning for many clients in one call.

        ``ops[i]`` is client i's dominant op direction, ``feats[i]`` its
        feature vector; ``rngs[i]`` (optional) is the client's own stream so
        exploration draws land exactly where the scalar path would put them.
        Returns one proposal (or None) per client.
        """
        n = len(ops)
        feats = np.asarray(feats, dtype=np.float32)
        if feats.shape[0] != n:
            raise ValueError(f"{n} ops but {feats.shape[0]} feature rows")
        t0 = perf_s()
        probs = np.empty((n, len(self._cands)), dtype=np.float64)
        t_inf = 0.0
        for op in dict.fromkeys(ops):      # unique, first-appearance order
            if op not in self.models and op not in self.grid_models:
                raise KeyError(op)         # mirror the scalar path
            rows = [i for i, o in enumerate(ops) if o == op]
            t1 = perf_s()
            probs[rows] = self._probs_many(op, feats[rows])
            t_inf += perf_s() - t1
        self.inference_time_total += t_inf
        chosen = self._select_many(ops, probs, rngs)
        self.tune_time_total += perf_s() - t0
        self.tune_count += n
        return [self._cands[int(k)] if k >= 0 else None for k in chosen]

    @property
    def mean_inference_s(self) -> float:
        return self.inference_time_total / max(self.tune_count, 1)

    @property
    def mean_tune_s(self) -> float:
        return self.tune_time_total / max(self.tune_count, 1)


class GreedyTuner(_TunerBase):
    """Pure greedy: argmax probability (paper's first attempt)."""

    def _select(self, op, probs, rng=None):
        return int(np.argmax(probs))

    def _select_many(self, ops, probs, rngs=None):
        return np.argmax(probs, axis=1)


class EpsilonGreedyTuner(_TunerBase):
    """Greedy with epsilon-random exploration (paper's second attempt).

    The batched path keeps the base per-row selection loop: each client's
    exploration draw must come from that client's own stream, in the same
    order as the scalar path, to stay bit-identical. Inference — the actual
    cost — is still one batched call.
    """

    def __init__(self, *args, epsilon: float = 0.1, **kw):
        super().__init__(*args, **kw)
        self.epsilon = epsilon

    def _select(self, op, probs, rng=None):
        rng = rng if rng is not None else self.rng
        if float(rng.uniform()) < self.epsilon:
            return int(rng.integers(0, len(probs)))
        return int(np.argmax(probs))


class ConditionalScoreGreedy(_TunerBase):
    """Algorithm 1: tau-filter + normalized progressive score."""

    def _select(self, op, probs, rng=None):
        keep = np.where(probs > self.tau)[0]            # line 1
        if keep.size == 0:
            return None                                 # retain current config
        theta = self._theta[keep]                       # line 2: MinMax over S
        lo, hi = theta.min(axis=0), theta.max(axis=0)
        tnorm = (theta - lo) / np.maximum(hi - lo, 1e-9)
        f = probs[keep]
        if op == "write":                               # line 5
            score = f * (1.0 + self.beta * tnorm.sum(axis=1))
        else:                                           # line 7
            score = f * (1.0 + self.alpha * tnorm[:, 0]) + tnorm[:, 1]
        return int(keep[np.argmax(score)])              # line 3

    def _select_many(self, ops, probs, rngs=None):
        # Vectorized Algorithm 1: masked MinMax + masked argmax per client.
        # Elementwise formulas and dtypes mirror _select exactly, so each
        # row's result is bit-identical to the scalar path.
        theta = self._theta                              # (c, 2)
        keep = probs > self.tau                          # (n, c)
        has = keep.any(axis=1)
        pos = np.float32(np.inf)
        with np.errstate(invalid="ignore"):
            lo = np.where(keep[:, :, None], theta[None], pos).min(axis=1)
            hi = np.where(keep[:, :, None], theta[None], -pos).max(axis=1)
            tnorm = ((theta[None] - lo[:, None, :])
                     / np.maximum(hi - lo, 1e-9)[:, None, :])
            write = np.asarray([o == "write" for o in ops])
            score_w = probs * (1.0 + self.beta * tnorm.sum(axis=2))
            score_r = (probs * (1.0 + self.alpha * tnorm[:, :, 0])
                       + tnorm[:, :, 1])
            score = np.where(write[:, None], score_w, score_r)
        score = np.where(keep, score, -np.inf)
        return np.where(has, np.argmax(score, axis=1), -1)


def make_tuner(
    kind: str,
    spaces: CaratSpaces,
    models: Dict[str, ProbFn],
    tau: float = 0.8,
    alpha: float = 0.5,
    beta: float = 0.5,
    epsilon: float = 0.1,
    rng: Optional[RngStream] = None,
    grid_models: Optional[Dict[str, GridProbFn]] = None,
) -> _TunerBase:
    if kind == "greedy":
        return GreedyTuner(spaces, models, tau, alpha, beta, rng,
                           grid_models=grid_models)
    if kind == "epsilon_greedy":
        return EpsilonGreedyTuner(spaces, models, tau, alpha, beta, rng,
                                  epsilon=epsilon, grid_models=grid_models)
    if kind == "conditional_score":
        return ConditionalScoreGreedy(spaces, models, tau, alpha, beta, rng,
                                      grid_models=grid_models)
    raise KeyError(f"unknown tuner {kind!r}")
