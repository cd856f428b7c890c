"""The LM stack of the port: the dense GQA family's serving path."""
from repro_torch.models.lm import LanguageModel, build_model
from repro_torch.models.param import ParamSpec, materialize, spec_tree_map

__all__ = ["ParamSpec", "materialize", "spec_tree_map", "LanguageModel",
           "build_model"]
