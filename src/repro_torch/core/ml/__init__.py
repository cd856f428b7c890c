"""CARAT's model zoo: GBDT (deployed) plus the paper's baselines.

The GBDT (with the committed production pair, ``default_models``), the
linear SVM and the torch nets load eagerly. The training-data sweep
(``collect_training_data``, ``TrainingData``) loads on first access (PEP
562): it drives simulations through the policy stack, which imports the
GBDT kernel wrappers, which import this package.
"""
from repro_torch.core.ml.gbdt import (ObliviousGBDT, default_models,
                                      gbdt_from_reference, load_gbdt,
                                      save_gbdt, train_gbdt)
from repro_torch.core.ml.nets import (FCNN, TCN, VanillaRNN,
                                      net_params_from_reference, train_net)
from repro_torch.core.ml.svm import LinearSVM, train_svm

_DATASET_EXPORTS = ("collect_training_data", "TrainingData")

__all__ = [
    "ObliviousGBDT", "train_gbdt", "LinearSVM", "train_svm",
    "FCNN", "VanillaRNN", "TCN", "train_net",
    "collect_training_data", "TrainingData",
    "default_models", "gbdt_from_reference", "load_gbdt", "save_gbdt",
    "net_params_from_reference",
]


def __getattr__(name):
    if name in _DATASET_EXPORTS:
        from repro_torch.core.ml import dataset
        return getattr(dataset, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_DATASET_EXPORTS))
