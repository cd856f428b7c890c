"""The reference's own workload shapes (``config/types.py`` ``SHAPES``)
on the CPU.

Decode at the positions ``long_500k`` reaches: the reduced decoder
configs of ``test_torch_lm.py`` (granite-3-2b, h2o-danube-1.8b's window
of 8, mamba2-370m, recurrentgemma-2b at 2 layers and at 3, whose third
block is the local attention with its window-8 ring), and danube and the
3-layer hybrid again at their published head dims (80 and 256), take
the same seeded cache and states in both packages, both caches'
``length`` at 524,272, then 16 steps to position 524,287: every step's
logits against the reference's decode step compiled, as its serving
engine runs it (``serve/engine.py``), at the decode tests' ``atol=5e-4``
(``tests/test_models.py:99``). Every ring is full from the first step
and wraps twice. The rotary angles are the compiled reference's bit for
bit at every head dim the shapes' archs use, up to position 524,287
(``test_rope_at_long_positions``): XLA folds the reference's frequencies
to constants in float64 and rounds them once, and the port computes them
so. The reference run op by op takes a float32 ``pow`` instead, an ulp
off for some frequencies, which moves the angle at position p by p such
ulps. A ring that wraps many times from position 0 is held to the
forward and the reference. Then a rehearsal of ``chip_smoke.py``'s
``reference_shapes`` phase at tiny widths: its seeded filler, its
records of what each cell cuts, its restore of a decode run, its plain
rows, and the phase end to end with the plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.config import get_arch as ref_get_arch
from repro.config import reduced_config as ref_reduced_config
from repro.models.lm import build_model as ref_build_model
from repro_torch.config import get_arch, list_archs, reduced_config
from repro_torch.config.types import SHAPES, ShapeConfig, get_shape
from repro_torch.core.ml.gbdt import default_models
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.convert import load_reference_params
from repro_torch.models.lm import build_model

CPU = torch.device("cpu")
ATOL = 5e-4
# (arch, depth, head dim): the reduced decoders of test_torch_lm.py, and
# danube and the hybrid at their published head dims
CASES = [("granite-3-2b", None, None), ("h2o-danube-1.8b", None, None),
         ("mamba2-370m", None, None), ("recurrentgemma-2b", None, None),
         ("recurrentgemma-2b", 3, None), ("h2o-danube-1.8b", None, 80),
         ("recurrentgemma-2b", 3, 256)]
LONG = get_shape("long_500k").seq_len
STEPS = 16
B = 2


def _id(case):
    name, depth, head_dim = case
    return name + (f"-{depth}L" if depth else "") + (
        f"-D{head_dim}" if head_dim else "")


def _pair(case, seed=1):
    """The reference model and its float32 params, and the port's model
    loaded with the same weights."""
    name, depth, head_dim = case
    ref_cfg = ref_reduced_config(ref_get_arch(name))
    cfg = reduced_config(get_arch(name))
    for field, value in (("n_layers", depth), ("head_dim", head_dim)):
        if value is not None:
            ref_cfg = dataclasses.replace(ref_cfg, **{field: value})
            cfg = dataclasses.replace(cfg, **{field: value})
    ref = ref_build_model(ref_cfg)
    params = ref.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    port = build_model(cfg, device="cpu", dtype=torch.float32)
    load_reference_params(port, jax.tree_util.tree_map(np.asarray, params))
    return cfg, ref, params, port


def _seeded_caches(port, ref, cache_len, lengths, seed):
    """The port's cache and the reference's with the same contents: every
    floating tensor drawn from N(0, 1) by a seeded NumPy generator, every
    ``length`` at ``lengths``; the reference's stacked (a leading layer
    axis) where its layers are scanned."""
    rng = np.random.default_rng(seed)
    cache = port.init_cache(B, cache_len, dtype=torch.float32)
    layers = []
    for layer in cache:
        arrays = {}
        for name, t in sorted(layer.items()):
            if name == "length":
                arrays[name] = np.asarray(lengths, np.int32)
            else:
                arrays[name] = rng.standard_normal(
                    tuple(t.shape)).astype(np.float32)
            t.copy_(torch.from_numpy(arrays[name]))
        layers.append(arrays)
    ref_cache = ref.init_cache(B, cache_len, dtype=jnp.float32)
    if isinstance(ref_cache, dict):
        ref_cache = {k: jnp.asarray(np.stack([a[k] for a in layers]))
                     for k in ref_cache}
    else:
        ref_cache = [{k: jnp.asarray(a[k]) for k in c}
                     for c, a in zip(ref_cache, layers)]
    return cache, ref_cache


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_decode_at_long_positions_matches_reference(case):
    """16 steps from a seeded, full cache at length 524,272 to position
    524,287: RoPE at those positions (at D 16, 80 and 256), the ring
    slots ``length % cache_len`` (danube's and the hybrid's rings of 8
    wrap twice, the others' of 32 are full), the SSM and RG-LRU states,
    every step's logits at the compiled reference's."""
    cfg, ref, params, port = _pair(case)
    start = LONG - STEPS
    cache, ref_cache = _seeded_caches(port, ref, 32, [start, start - 37],
                                      seed=5)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                               size=(STEPS, B))
    step = jax.jit(ref.decode_step)
    for j in range(STEPS):
        pos = np.full((B,), start + j, np.int32)
        got, cache = port.decode_step(torch.from_numpy(tokens[j]), cache,
                                      torch.from_numpy(pos))
        want, ref_cache = step(params, jnp.asarray(tokens[j]), ref_cache,
                               jnp.asarray(pos))
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for c in cache:
        if "length" in c:
            assert c["length"].tolist() == [LONG, LONG - 37]


@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
def test_rope_at_long_positions(d):
    """The port's rotary angles at the positions the shapes reach, up to
    524,287, at every theta of the repo's archs, are the compiled
    reference's bit for bit, and its rotation within float32's rounding
    of the compiled reference's and of float64 rotation by the same
    angles. The frequencies of the reference run op by op (a float32
    ``pow``) are at most an ulp from them, and at some dims that ulp
    moves its angle at 524,287 by more than 1e-3."""
    from repro.models import layers as ref_layers
    from repro_torch.models import layers
    pos = np.array([[0, 100, 4095, 32767, LONG - STEPS, LONG - 1]] * 2,
                   np.int32)
    x = np.random.default_rng(d).standard_normal((2, 4, 6, d)).astype(
        np.float32)
    thetas = sorted({get_arch(n).rope_theta for n in list_archs()})
    eager_gap = 0.0
    for theta in thetas:
        angles = jax.jit(lambda p: ref_layers.rope_angles(p, d, theta))
        ang = layers.rope_angles(torch.from_numpy(pos), d, theta)
        assert np.array_equal(ang.numpy(), np.asarray(angles(pos))), theta
        c, s = (f(ang.double().numpy())[:, None] for f in (np.cos, np.sin))
        x1, x2 = np.split(x.astype(np.float64), 2, axis=-1)
        want = np.concatenate([x1 * c - x2 * s, x1 * s + x2 * c], axis=-1)
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta).numpy()
        compiled = jax.jit(lambda x, p: ref_layers.apply_rope(x, p, theta))
        assert np.abs(got - want).max() <= 1e-6, theta
        assert np.abs(got - np.asarray(compiled(x, pos))).max() <= 1e-6
        freqs = layers.rope_freqs(d, theta, "cpu").numpy()
        with jax.disable_jit():
            eager = np.asarray(1.0 / (theta ** (
                jnp.arange(0, d, 2, dtype=jnp.float32) / d)))
            eager_ang = np.asarray(ref_layers.rope_angles(
                jnp.asarray(pos), d, theta))
        ulps = np.abs(freqs.view(np.int32).astype(np.int64)
                      - eager.view(np.int32))
        assert ulps.max() <= 1, theta
        eager_gap = max(eager_gap, float(np.abs(eager_ang - ang.numpy())
                                         [:, -1].max()))
    if d != 16:
        assert eager_gap > 1e-3


@pytest.mark.parametrize("case", [("h2o-danube-1.8b", None, None),
                                  ("recurrentgemma-2b", 3, None)], ids=_id)
def test_ring_wraps_many_times_past_the_window(case):
    """A window-8 ring written from position 0 for 45 steps (full after
    8, then wrapped four times more): every step's logits equal the
    forward's (whose mask keeps the same 8 keys) and the reference's
    decode."""
    cfg, ref, params, port = _pair(case)
    s = 45
    window = cfg.sliding_window or cfg.rglru.attn_window
    assert s > 5 * window
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                               size=(B, s)).astype(np.int32)
    fwd, _ = port.forward({"tokens": torch.from_numpy(tokens)})
    cache = port.init_cache(B, 64, dtype=torch.float32)
    ref_cache = ref.init_cache(B, 64, dtype=jnp.float32)
    assert {c["k"].shape[2] for c in cache if "k" in c} == {window}
    for t in range(s):
        pos = np.full((B,), t, np.int32)
        got, cache = port.decode_step(torch.from_numpy(tokens[:, t]), cache,
                                      torch.from_numpy(pos))
        want, ref_cache = ref.decode_step(params, jnp.asarray(tokens[:, t]),
                                          ref_cache, jnp.asarray(pos))
        np.testing.assert_allclose(got.numpy(), fwd[:, t].numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ------------------------------- a rehearsal of the reference_shapes phase
def test_reference_cells_are_the_dry_runs_cells_cut_in_batch_only():
    """The phase's cells are the reference's shapes by their own names,
    named as the dry run names them, long_500k only for sub-quadratic
    archs, and each cuts the batch and nothing else."""
    cells = chip_smoke.reference_cells(get_arch)
    names = [chip_smoke.cell_name(c["published"].name, c["shape"].name)
             for c in cells]
    assert names == ["granite-3-2b x prefill_32k",
                     "granite-3-2b x decode_32k",
                     "granite-3-2b x train_4k", "mamba2-370m x long_500k",
                     "recurrentgemma-2b x long_500k",
                     "h2o-danube-1.8b x long_500k"]
    batches = {}
    for c in cells:
        assert c["shape"] in SHAPES and c["cfg"] is c["published"]
        if c["shape"].name == "long_500k":
            assert c["published"].sub_quadratic
        cuts = chip_smoke.shape_cuts(c["published"], c["cfg"], c["shape"],
                                     c["batch"])
        assert all(x["what"] == "batch" for x in cuts)
        batches[c["shape"].name] = [(x["reference"], x["run"])
                                    for x in cuts]
    assert batches == {"prefill_32k": [(32, 1)], "decode_32k": [(128, 16)],
                       "train_4k": [(256, 1)], "long_500k": []}
    # the card-vs-CPU runs: the hybrid's holds a local-attention block
    rg = next(c for c in cells if c["published"].name == "recurrentgemma-2b")
    assert rg["parity"]["layers"] == 3
    train = next(c for c in cells if c["shape"].name == "train_4k")
    assert train["parity_cfg"] == reduced_config(get_arch("granite-3-2b"))


def test_shape_cuts_list_every_cut():
    granite = get_arch("granite-3-2b")
    small = dataclasses.replace(reduced_config(granite), n_layers=3)
    shape = ShapeConfig("decode_32k", 512, 128, "decode")
    cuts = chip_smoke.shape_cuts(granite, small, shape, 4)
    assert [c["what"] for c in cuts] == [
        "batch", "seq_len", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab_size", "head_dim"]
    assert cuts[0] == {"what": "batch", "reference": 128, "run": 4}
    assert cuts[1] == {"what": "seq_len", "reference": 32768, "run": 512}
    assert chip_smoke.shape_cuts(granite, granite, get_shape("decode_32k"),
                                 128) == []
    # an SSM has no heads: no head dim to compare
    mamba = get_arch("mamba2-370m")
    assert chip_smoke.shape_cuts(mamba, mamba, get_shape("long_500k"),
                                 1) == []


@pytest.mark.parametrize("name", ["granite-3-2b", "mamba2-370m",
                                  "recurrentgemma-2b"])
def test_fill_cache_is_seeded(name):
    cfg = dataclasses.replace(reduced_config(get_arch(name)), n_layers=3)
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16)

    def filled(seed):
        return chip_smoke.fill_cache_(
            model.init_cache(2, 16, dtype=torch.bfloat16),
            torch.Generator().manual_seed(seed), [11, 5])

    a, b, c = filled(3), filled(3), filled(4)
    for x, y, z in zip(a, b, c):
        assert sorted(x) == sorted(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k
            if k == "length":
                assert x[k].tolist() == [11, 5] and x[k].dtype == torch.int32
            else:
                assert not torch.equal(x[k], z[k]), k
                assert float(x[k].float().std()) > 0.5


@pytest.mark.parametrize("cache_len,fills", [(64, False), (8, True)])
def test_cache_keeper_restores_a_decode_run(cache_len, fills):
    """Two runs of the same steps from a kept state give the same logits:
    keys and values are copied only where a ring fills within the run."""
    cfg = reduced_config(get_arch("granite-3-2b"))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    cache = chip_smoke.fill_cache_(
        model.init_cache(2, cache_len, dtype=torch.float32),
        torch.Generator().manual_seed(1), [4, 2])
    steps = 6
    keep = chip_smoke.cache_keeper(cache, steps)
    assert all(("k" in kept) == fills for kept in keep)

    def run():
        chip_smoke.restore_cache_(cache, keep)
        out = []
        for j in range(steps):
            logits, _ = model.decode_step(torch.tensor([3, 9]), cache,
                                          torch.tensor([4 + j, 4 + j]))
            out.append(logits)
        return out

    first, again = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("window", [0, 8])
def test_plain_version_of_a_slice_of_rows(window):
    """``flash_attention_ref``'s ``q_offset``: a slice of query rows
    placed at its positions gives the whole sequence's rows (the phase's
    K2 gate at S 32,768), and the phase's chunked plain version gives
    the whole."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((1, 4, 40, 16), (1, 2, 40, 16), (1, 2, 40, 16)))
    want = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(flash_attention_ref(
        q[:, :, 24:], k, v, causal=True, window=window, q_offset=24),
        want[:, :, 24:])
    if window == 0:
        torch.testing.assert_close(
            chip_smoke._plain_causal(q, k, v, chunk=16), want)


def _rehearsal_cells():
    """The phase's cells at reduced widths (the hybrid at 3 layers, so
    that its local attention decodes), prefill_32k cut to 256 positions
    and train_4k to 64, every batch at most 3."""
    out = []
    for c in chip_smoke.reference_cells(get_arch):
        cfg = reduced_config(c["published"])
        if cfg.rglru is not None:
            cfg = dataclasses.replace(cfg, n_layers=3)
        shape = c["shape"]
        if shape.name in ("prefill_32k", "train_4k"):
            shape = dataclasses.replace(
                shape, seq_len=256 if shape.kind == "prefill" else 64)
        cell = dict(c, cfg=cfg, shape=shape, batch=min(c["batch"], 3))
        if "most" in c:
            # the batch probe's start and cap: on the CPU no batch runs
            # out of memory
            cell["probe_from"] = cell["most"] = 2
        out.append(cell)
    return out


def test_reference_shapes_phase_on_cpu():
    """The phase end to end with the plain versions: every cell's record,
    its cuts (here widths and depth as well), the decode runs at the
    shapes' positions with ragged lengths, each kernel row's keys, and
    the kernel line's rows of the cells."""
    m_read, m_write = default_models()
    res = chip_smoke.phase_reference_shapes(
        CPU, _rehearsal_cells(), {"read": m_read, "write": m_write}, reps=1)
    cells = res["cells"]
    assert list(cells) == [chip_smoke.cell_name(a, s) for a, s, _ in
                           chip_smoke.REFERENCE_CELLS]
    for name, c in cells.items():
        whats = [x["what"] for x in c["reduced"]]
        assert "d_model" in whats and "vocab_size" in whats, name
        assert ("batch" in whats) == (c["reference_batch"] != c["batch"])
    pre = cells["granite-3-2b x prefill_32k"]
    assert pre["prefill"]["tokens_per_s"] > 0
    assert pre["path_launches"] == {"flash_attention": 0}
    (k2,) = pre["kernels"]
    assert k2["max_abs_err"] == 0.0 and k2["checked"]["row_starts"] == [
        0, 128]
    assert k2["shape"] == [1, 4, 1, 256, 16] and k2["bound_ms"] > 0.0
    dec = cells["granite-3-2b x decode_32k"]["decode"]
    assert dec["positions"] == [32760, 32767]
    assert dec["lengths"] == [32760, 32723, 32686]
    assert cells["granite-3-2b x decode_32k"]["parity"]["max_abs_err"] == 0
    for arch in ("mamba2-370m", "recurrentgemma-2b", "h2o-danube-1.8b"):
        c = cells[f"{arch} x long_500k"]
        assert c["decode"]["positions"] == [LONG - 16, LONG - 1]
        assert c["parity"]["positions"] == [LONG - 4, LONG - 1]
        assert len(c["kernels"]) == (arch != "mamba2-370m")
    train = cells["granite-3-2b x train_4k"]
    assert train["train"]["same_batch"] and train["train"]["steps"] == 3
    # the reference's training configuration, parallel_for's settings
    assert train["parallel"] == {"remat": "full", "microbatches": 1,
                                 "opt_state_dtype": "float32"}
    assert train["train"]["dtype"] == "bfloat16"
    assert train["train"]["warmup_steps"] == 0
    # the largest batch the probe fits, up to the cap (2 here): no probe
    # ran out of memory, so there is no next batch's
    assert train["batch"] == 2 and "next_batch" not in train
    assert train["batch_probes"] == [{"batch": 2, "seq": 64, "fits": True,
                                      "peak_device_bytes": None,
                                      "error": None}]
    assert train["parity"]["seq"] == 64
    assert train["parity"]["dtype"] == "bfloat16"
    rows = chip_smoke.kernel_line(
        {n: k2 for n in chip_smoke.KERNELS},
        {n: 1 for n in chip_smoke.KERNELS}, res)["kernels"]
    extra = [r["name"] for r in rows[len(chip_smoke.KERNELS):]]
    assert extra == [
        "flash_attention [granite-3-2b x prefill_32k]",
        "decode_attention [granite-3-2b x decode_32k]",
        "flash_attention [granite-3-2b x train_4k]",
        "decode_attention [recurrentgemma-2b x long_500k]",
        "decode_attention [h2o-danube-1.8b x long_500k]"]
    for r in rows:
        assert set(r) == {"name", "route", "source", "replaces", "launches",
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms"}
    summary = chip_smoke.shape_summary(res)
    assert set(summary) == set(cells)
    assert "next_batch" not in summary["granite-3-2b x train_4k"]
