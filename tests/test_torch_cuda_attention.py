"""The port's attention kernels and serving path on a CUDA device.

Every test here is marked ``cuda`` and skips without a CUDA device. Each
kernel is held against its plain torch version on the same card and
inputs (bfloat16 ``atol=2e-2``, float32 ``atol=2e-5``, the reference's
tolerances; bfloat16 also within 2e-2 of each output row's largest
value, since a row that averages many keys has values about as small as
the absolute tolerance) over head dims 16, 64, 80, 128 and 256, ragged lengths, GQA
ratios 1, 4 and 8 and the three mask kinds, and each test asserts that
the kernel launched (its counter moved). This file imports only the
port, NumPy and torch, so it runs on a machine without JAX::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.config import get_arch, reduced_config
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.lm import build_model
from repro_torch.serve import Request, ServeEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GQA = [(4, 4), (8, 2), (8, 1)]        # Hq / Hkv = 1, 4, 8
MASKS = [(True, 0), (True, 24), (False, 0)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _normal(dev, seed, dtype, *shapes):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in shapes]


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _assert_close(got, want):
    """Within TOL of ``want``'s dtype; in bfloat16 also within 2e-2 of
    each output row's largest |value| (rows along the last dim)."""
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= TOL[want.dtype]
    if want.dtype == torch.bfloat16:
        scale = want.float().abs().amax(dim=-1).clamp_min(1e-30)
        assert float((diff.amax(dim=-1) / scale).max()) <= 2e-2


# ----------------------------------------------------------- flash attention
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("hq,hkv", GQA)
@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(dev, dtype, d, hq, hkv, causal,
                                       window):
    s = 100                            # a ragged tail past 64-row tiles
    q, k, v = _normal(dev, d + hq, dtype, (2, hq, s, d), (2, hkv, s, d),
                      (2, hkv, s, d))
    scale = float(d) ** -0.5           # the kernel's default, for any d
    before = fa_kernel.launches["flash_attention"]
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize(dev)
    assert fa_kernel.launches["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               scale=scale)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_close(got, want)


@pytest.mark.parametrize("sq,sk,d,dtype", [
    (1000, 1000, 64, torch.float32),
    (37, 300, 256, torch.bfloat16),     # Sq != Sk; 214 KB of shared memory
    (1, 1, 64, torch.float32),
    (130, 70, 32, torch.bfloat16),
])
def test_flash_attention_shapes(dev, sq, sk, d, dtype):
    q, k, v = _normal(dev, 7, dtype, (1, 8, sq, d), (1, 2, sk, d),
                      (1, 2, sk, d))
    before = fa_kernel.launches["flash_attention"]
    got = fa_kernel.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize(dev)
    assert fa_kernel.launches["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v, causal=True, scale=float(d) ** -0.5)
    _assert_close(got, want)


def test_flash_attention_reads_strided_views(dev):
    """The model's (B, S, H, D) projections, transposed without a copy."""
    q, k, v = _normal(dev, 8, torch.bfloat16, (2, 90, 8, 64),
                      (2, 90, 2, 64), (2, 90, 2, 64))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    got = fa_kernel.flash_attention(q, k, v, causal=True, window=16)
    want = flash_attention_ref(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True, window=16)
    _assert_close(got, want)


# ----------------------------------------------------------- decode attention
@pytest.mark.parametrize("hq,hkv", GQA + [(24, 2)])   # 12: two group tiles
@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_plain(dev, dtype, d, hq, hkv):
    b, s = 3, 300
    q, k, v = _normal(dev, d + hq, dtype, (b, hq, d), (b, hkv, s, d),
                      (b, hkv, s, d))
    lengths = torch.tensor([s, 1, 137], dtype=torch.int32, device=dev)
    before = dec_kernel.launches["decode_attention"]
    got = dec_kernel.decode_attention(q, k, v, lengths=lengths)
    torch.cuda.synchronize(dev)
    assert dec_kernel.launches["decode_attention"] == before + 1
    want = decode_attention_ref(q, k, v, lengths=lengths)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_close(got, want)


@pytest.mark.parametrize("q_dtype,cache_dtype", [
    (torch.bfloat16, torch.float32),   # the engine's default cache
    (torch.float32, torch.bfloat16),
])
def test_decode_attention_mixed_dtypes(dev, q_dtype, cache_dtype):
    """q in one type over a cache in another, both read as float32 as in
    the plain version; the output takes q's type."""
    (q,) = _normal(dev, 11, q_dtype, (3, 8, 64))
    k, v = _normal(dev, 12, cache_dtype, (3, 2, 300, 64), (3, 2, 300, 64))
    lengths = torch.tensor([300, 1, 137], dtype=torch.int32, device=dev)
    before = dec_kernel.launches["decode_attention"]
    got = dec_kernel.decode_attention(q, k, v, lengths=lengths)
    torch.cuda.synchronize(dev)
    assert dec_kernel.launches["decode_attention"] == before + 1
    want = decode_attention_ref(q, k, v, lengths=lengths)
    assert got.dtype == q_dtype and got.shape == want.shape
    _assert_close(got, want)


def test_decode_attention_ignores_positions_past_length(dev):
    q, k, v = _normal(dev, 9, torch.float32, (2, 8, 64), (2, 2, 512, 64),
                      (2, 2, 512, 64))
    lengths = torch.tensor([40, 300], dtype=torch.int32, device=dev)
    base = dec_kernel.decode_attention(q, k, v, lengths=lengths)
    k[:, :, 300:] = 99.0
    v[:, :, 300:] = -99.0
    k[0, :, 40:] = 99.0
    pert = dec_kernel.decode_attention(q, k, v, lengths=lengths)
    assert torch.equal(base, pert)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 4, 8, 64), dtype=torch.float16, device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_kernel.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 8, 512), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 64), device=dev)
    k = torch.zeros((1, 4, 8, 64), device=dev)
    with pytest.raises(ValueError, match="lengths"):
        dec_kernel.decode_attention(q, k, k, lengths=torch.ones(
            1, dtype=torch.int64, device=dev))


# ------------------------------------------------------------ serving path
def test_serve_engine_on_cuda(dev):
    """Reduced granite on the card: decode matches the forward, every
    layer's attention went through the kernels, and the engine's tokens
    equal those of the same model on the CPU."""
    cfg = reduced_config(get_arch("granite-3-2b"))
    cpu = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu.init(torch.Generator().manual_seed(0))
    model = build_model(cfg, device=dev, dtype=torch.float32)
    model.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(2, 12), dtype=np.int64)).to(dev)
    fa_kernel.reset_launches()
    dec_kernel.reset_launches()
    with torch.inference_mode():
        fwd, _ = model.forward({"tokens": tokens})
        assert fa_kernel.launches["flash_attention"] == cfg.n_layers
        cache = model.init_cache(2, 16, dtype=torch.float32)
        for t in range(12):
            lg, cache = model.decode_step(
                tokens[:, t], cache,
                torch.full((2,), t, dtype=torch.int32, device=dev))
            assert _max_err(lg, fwd[:, t]) <= 5e-4
    assert dec_kernel.launches["decode_attention"] == 12 * cfg.n_layers
    reqs = [([1, 2, 3], 5), ([7, 8], 5)]
    out = [[r.out_tokens for r in ServeEngine(m, cache_len=64).generate(
        [Request(p, n) for p, n in reqs])] for m in (cpu, model)]
    assert out[0] == out[1]


def test_serve_engine_bf16_model_over_default_cache(dev):
    """A bfloat16 model under the engine's default float32 cache: the
    decode kernel takes the two types, every step of every layer."""
    cfg = reduced_config(get_arch("granite-3-2b"))
    model = build_model(cfg, device=dev, dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, cache_len=64)
    assert engine.cache_dtype == torch.float32
    dec_kernel.reset_launches()
    reqs = engine.generate([Request([1, 2, 3], 5), Request([7, 8], 5)])
    assert dec_kernel.launches["decode_attention"] == (3 + 5) * cfg.n_layers
    for r in reqs:
        assert len(r.out_tokens) == 5
        assert all(0 <= t < cfg.vocab_size for t in r.out_tokens)
