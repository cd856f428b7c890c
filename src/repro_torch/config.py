"""CARAT hyper-parameters (the port's copy of ``CaratConfig``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CaratConfig:
    """CARAT hyper-parameters (paper §III, §IV defaults)."""
    enable: bool = True
    probe_interval_s: float = 0.5        # paper: 0.5 s probing interval
    history_k: int = 1                   # paper §III-C: k=1 best
    improve_eps: float = 0.15            # "better" threshold ε = 15%
    prob_tau: float = 0.8                # candidate filter threshold τ
    alpha: float = 0.5                   # ReadScore weight
    beta: float = 0.5                    # WriteScore weight
    tuner: str = "conditional_score"     # greedy | epsilon_greedy | conditional_score
    epsilon: float = 0.1                 # for the ε-greedy baseline
    model: str = "gbdt"                  # svm | fcnn | rnn | tcn | gbdt
    inactive_threshold_s: float = 1.0    # I/O-inactive boundary (>1 s, §III-A)
    # phase re-probing (replayed/dynamic workloads): when the app-level I/O
    # signature shifts (op-mix flip or >reprobe_req_ratio request-size
    # change), reset RPC params to the space default — the trained model's
    # confident region — and re-tune from there (IOPathTune/DIAL-style
    # change response; static workloads never trigger it)
    reprobe_on_change: bool = True
    reprobe_req_ratio: float = 2.0       # request-size shift that counts
    reprobe_cooldown_s: float = 2.0      # min time between resets
