"""Oblivious-GBDT inference: the port of ``repro.kernels.gbdt_infer``."""
