"""CARAT's deployed model: the oblivious GBDT (the reference's baselines
``nets``/``svm`` and the training-data sweep are not ported yet)."""
from repro_torch.core.ml.gbdt import (ObliviousGBDT, default_models,
                                      gbdt_from_reference, load_gbdt,
                                      save_gbdt, train_gbdt)

__all__ = ["ObliviousGBDT", "default_models", "gbdt_from_reference",
           "load_gbdt", "save_gbdt", "train_gbdt"]
