"""CPU parity of the port's input pipeline (``repro_torch.data``) with the
reference's.

Twins of the data half of ``tests/test_data_serve.py``, then the port
held to ``repro`` with ``==``: the token source and the host batches of
the dense, VLM and audio families, and the PFS pipeline (4 hosts, the
production GBDT pair carried across, CARAT on and off) fed one seeded
sequence of compute times: every wait, the stats, the throughput and
each host controller's decisions. The port's controllers score through
the kernel-backed ``GBDTScorer`` (on the CPU its plain version): one
``gbdt_logits`` call per scorer call.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config import reduced_config as ref_reduced_config
from repro.config.types import CaratConfig as RefCaratConfig
from repro.config.types import DataConfig as RefDataConfig
from repro.config.types import ShapeConfig as RefShapeConfig
from repro.data.pipeline import PFSDataPipeline as RefPipeline
from repro.data.pipeline import TokenSource as RefTokenSource
from repro.data.pipeline import make_host_batch as ref_make_host_batch
from repro_torch.config import (ArchConfig, AttentionKind, CaratConfig,
                                DataConfig, Family, ShapeConfig, get_arch,
                                reduced_config)
from repro_torch.core.ml.gbdt import gbdt_from_reference
from repro_torch.data import PFSDataPipeline, TokenSource, make_host_batch
from repro_torch.kernels.gbdt_infer import ops as gbdt_ops

FAMILIES = ["granite-3-2b", "paligemma-3b", "hubert-xlarge"]


def _port_cfg(name):
    """The port's copy of a reference reduced config (the VLM and audio
    archs have no port config yet: their families are not ported; the
    batch needs only the config's numbers)."""
    ref = ref_reduced_config(ref_get_arch(name))
    kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    kw["family"] = Family(ref.family.value)
    kw["attention"] = AttentionKind(ref.attention.value)
    return ArchConfig(**kw)


# ------------------------------------------ twins of test_data_serve.py
def test_token_source_deterministic():
    src = TokenSource(vocab_size=100, seed=1)
    a = src.batch(3, 0, 4, 16)
    b = src.batch(3, 0, 4, 16)
    c = src.batch(4, 0, 4, 16)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.max() < 100 and a.min() >= 0


def test_host_batch_families():
    for arch in FAMILIES:
        cfg = _port_cfg(arch)
        src = TokenSource(cfg.vocab_size)
        b = make_host_batch(cfg, 16, 2, src, step=0)
        assert "labels" in b
        if cfg.frontend == "patch":
            assert b["patches"].shape == (2, cfg.frontend_tokens, cfg.d_model)
        if cfg.frontend == "frame":
            assert b["frames"].shape == (2, 16, cfg.d_model)


def test_pipeline_waits_when_storage_slow():
    cfg = reduced_config(get_arch("granite-3-2b"))
    # enormous per-step demand with minimal compute time => must wait
    data = DataConfig(sample_bytes=64 * 1024 * 1024)
    pipe = PFSDataPipeline(cfg, data, n_hosts=2, device="cpu")
    shape = ShapeConfig("t", 128, 64, "train")
    wait = pipe.step(shape, compute_time_s=0.5)
    assert wait > 0.0
    assert pipe.stats.steps == 1


def test_pipeline_no_wait_when_storage_fast():
    cfg = reduced_config(get_arch("granite-3-2b"))
    data = DataConfig(sample_bytes=4096)
    pipe = PFSDataPipeline(cfg, data, n_hosts=2, device="cpu")
    shape = ShapeConfig("t", 128, 8, "train")
    waits = [pipe.step(shape, compute_time_s=1.0) for _ in range(5)]
    assert waits[-1] == 0.0


# ----------------------------------------------------- against the reference
@pytest.mark.parametrize("arch", FAMILIES)
def test_host_batches_equal_the_references(arch):
    cfg = _port_cfg(arch)
    ref_cfg = ref_reduced_config(ref_get_arch(arch))
    for seed, step, host in ((0, 0, 0), (3, 7, 2), (11, 1, 5)):
        got = make_host_batch(cfg, 16, 3, TokenSource(cfg.vocab_size, seed),
                              step, host)
        want = ref_make_host_batch(ref_cfg, 16, 3,
                                   RefTokenSource(cfg.vocab_size, seed),
                                   step, host)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def port_models(tiny_models):
    return {op: gbdt_from_reference(m.feat, m.thr, m.leaf, m.base,
                                    m.n_features)
            for op, m in tiny_models.items()}


def _compute_times(n, seed=4):
    """Step times from a few ms (launch-bound) to over a sim interval."""
    return list(np.random.default_rng(seed).uniform(0.002, 1.3, size=n))


@pytest.mark.parametrize("carat", [False, True])
def test_pipeline_matches_reference(tiny_models, port_models, carat):
    """The launcher's configuration (4 hosts, 2 MiB samples, batch 8) on
    one compute-time sequence: waits, stats, throughput and decisions
    equal the reference's with ``==``."""
    cfg = reduced_config(get_arch("granite-3-2b"))
    ref_cfg = ref_reduced_config(ref_get_arch("granite-3-2b"))
    pipe = PFSDataPipeline(cfg, DataConfig(sample_bytes=2048 * 1024),
                           n_hosts=4, carat=CaratConfig(enable=carat),
                           models=port_models, device="cpu")
    ref = RefPipeline(ref_cfg, RefDataConfig(sample_bytes=2048 * 1024),
                      n_hosts=4, carat=RefCaratConfig(enable=carat),
                      models=tiny_models)
    shape, ref_shape = (ShapeConfig("d", 64, 8, "train"),
                        RefShapeConfig("d", 64, 8, "train"))
    for c in _compute_times(40):
        assert pipe.step(shape, c) == ref.step(ref_shape, c)
    assert dataclasses.asdict(pipe.stats) == dataclasses.asdict(ref.stats)
    assert pipe.throughput() == ref.throughput()
    assert pipe.sim.t == ref.sim.t
    assert len(pipe.controllers) == len(ref.controllers) == (4 if carat
                                                             else 0)
    for a, b in zip(pipe.controllers, ref.controllers):
        assert a.decisions == b.decisions
    if carat:
        assert sum(len(c.decisions) for c in pipe.controllers) > 0


def test_pipeline_scores_each_call_through_the_kernel_op(port_models,
                                                         monkeypatch):
    """Every stage-1 proposal and bootstrap pick of the hosts'
    controllers is one ``gbdt_logits`` call on the pipeline's device."""
    calls = []
    inner = gbdt_ops.gbdt_logits

    def counted(x, *args):
        calls.append(x.device)
        return inner(x, *args)

    monkeypatch.setattr(gbdt_ops, "gbdt_logits", counted)
    cfg = reduced_config(get_arch("granite-3-2b"))
    pipe = PFSDataPipeline(cfg, DataConfig(sample_bytes=2048 * 1024),
                           n_hosts=4, carat=CaratConfig(),
                           models=port_models, device="cpu")
    shape = ShapeConfig("d", 64, 8, "train")
    for c in _compute_times(30, seed=9):
        pipe.step(shape, c)
    bootstraps = sum(d[1] == "bootstrap" for c in pipe.controllers
                     for d in c.decisions)
    proposals = sum(c.tuner.tune_count for c in pipe.controllers)
    assert proposals > 0
    assert len(calls) == bootstraps + proposals
    assert set(calls) == {torch.device("cpu")}


def test_pipeline_device_defaults_to_cuda():
    cfg = reduced_config(get_arch("granite-3-2b"))
    if torch.cuda.is_available():
        assert PFSDataPipeline(cfg, DataConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PFSDataPipeline(cfg, DataConfig())
