"""The LM stack of the port: one composable stack for the dense GQA, MoE,
SSM, RG-LRU hybrid, VLM and audio families."""
from repro_torch.models.lm import LanguageModel, build_model
from repro_torch.models.param import (ParamSpec, abstract, materialize,
                                     spec_tree_map)

__all__ = ["ParamSpec", "materialize", "abstract", "spec_tree_map",
           "LanguageModel", "build_model"]
