"""Model training orchestration + persistence.

``get_default_models`` is the entry the framework uses: it returns the
read/write GBDT pair (the paper's production choice), training-and-caching
on first use. ``train_all_models`` reproduces Table IV across the five
architectures the paper compares.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.ml.dataset import TrainingData, collect_training_data
from repro_torch.core.ml.gbdt import (ObliviousGBDT, load_gbdt, save_gbdt,
                                      train_gbdt)
from repro_torch.core.ml.nets import FCNN, TCN, VanillaRNN, train_net
from repro_torch.core.ml.svm import train_svm
from repro_torch.device import DeviceLike
from repro_torch.utils.logging import get_logger

log = get_logger("core.ml.train")

# <REPRO_CACHE or the repository's .cache>/torch: the port's models never
# share a file with the reference's, which caches in the directory itself
DEFAULT_CACHE = os.path.join(
    os.environ.get("REPRO_CACHE",
                   str(Path(__file__).resolve().parents[4] / ".cache")),
    "torch")

__all__ = ["DEFAULT_CACHE", "ModelReport", "get_default_models",
           "load_gbdt", "save_gbdt", "train_all_models"]


# ---------------------------------------------------------------- entry points
def get_default_models(
    cache_dir: str = DEFAULT_CACHE,
    reps: int = 32,
    duration_s: float = 60.0,
    seed: int = 0,
    force: bool = False,
) -> Tuple[ObliviousGBDT, ObliviousGBDT]:
    """Read/write GBDT pair, trained per the paper's §IV-B protocol."""
    pr = os.path.join(cache_dir, f"gbdt_read_s{seed}.npz")
    pw = os.path.join(cache_dir, f"gbdt_write_s{seed}.npz")
    if not force and os.path.exists(pr) and os.path.exists(pw):
        return load_gbdt(pr), load_gbdt(pw)
    log.info("training CARAT GBDT models (reps=%d, %ds workloads)...",
             reps, int(duration_s))
    data = collect_training_data(reps=reps, duration_s=duration_s, seed=seed)
    (Xtr, ytr, Xva, yva), (Xtw, ytw, Xvw, yvw) = data.split()
    m_r = train_gbdt(Xtr, ytr, X_val=Xva, y_val=yva, n_trees=400, depth=5,
                     seed=seed)
    m_w = train_gbdt(Xtw, ytw, X_val=Xvw, y_val=yvw, n_trees=400, depth=5,
                     seed=seed)
    err_r = float(np.mean(m_r.predict(Xva) != yva))
    err_w = float(np.mean(m_w.predict(Xvw) != yvw))
    log.info("GBDT error rates: read=%.3f write=%.3f", err_r, err_w)
    save_gbdt(m_r, pr)
    save_gbdt(m_w, pw)
    return m_r, m_w


@dataclass
class ModelReport:
    name: str
    read_error: float
    write_error: float


def train_all_models(
    data: Optional[TrainingData] = None,
    reps: int = 32,
    duration_s: float = 60.0,
    seed: int = 0,
    device: DeviceLike = None,
) -> Dict[str, ModelReport]:
    """Table IV: error rates of SVM / FC-NN / RNN / TCN / GBDT; the nets
    train on ``device`` (``cuda`` unless another is named)."""
    if data is None:
        data = collect_training_data(reps=reps, duration_s=duration_s, seed=seed)
    (Xtr, ytr, Xva, yva), (Xtw, ytw, Xvw, yvw) = data.split()
    in_dim = Xtr.shape[1]
    reports: Dict[str, ModelReport] = {}

    def err(model, X, y):
        return float(np.mean(model.predict(X) != y))

    # SVM
    svm_r = train_svm(Xtr, ytr, seed=seed)
    svm_w = train_svm(Xtw, ytw, seed=seed)
    reports["svm"] = ModelReport("svm", err(svm_r, Xva, yva), err(svm_w, Xvw, yvw))

    # Neural nets
    for arch_cls, name in ((FCNN, "fcnn"), (VanillaRNN, "rnn"), (TCN, "tcn")):
        m_r = train_net(arch_cls(in_dim), Xtr, ytr, Xva, yva, seed=seed,
                        device=device)
        m_w = train_net(arch_cls(in_dim), Xtw, ytw, Xvw, yvw, seed=seed,
                        device=device)
        reports[name] = ModelReport(name, err(m_r, Xva, yva), err(m_w, Xvw, yvw))

    # GBDT
    g_r = train_gbdt(Xtr, ytr, X_val=Xva, y_val=yva, n_trees=400, depth=5,
                     seed=seed)
    g_w = train_gbdt(Xtw, ytw, X_val=Xvw, y_val=yvw, n_trees=400, depth=5,
                     seed=seed)
    reports["gbdt"] = ModelReport("gbdt", err(g_r, Xva, yva), err(g_w, Xvw, yvw))
    return reports
