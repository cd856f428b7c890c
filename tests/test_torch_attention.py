"""CPU parity of the port's attention ops with the reference's.

The same seeded NumPy inputs go through the port's ops on CPU tensors
(their plain torch versions) and through ``repro``'s ops with
``backend="pallas"`` (the TPU kernels in interpret mode, as
``tests/test_kernels.py`` runs them) and ``backend="xla"`` (the
oracles). Tolerances are the reference tests': float32 ``atol=2e-5``,
bfloat16 ``atol=2e-2`` (``tests/test_kernels.py:32,96``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import \
    decode_attention as ref_decode_attention
from repro.kernels.flash_attention.ops import \
    flash_attention as ref_flash_attention
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention

BACKENDS = ["pallas", "xla"]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(x, jdt, tdt):
    """One float32 array as a jax and a torch (CPU) array of one dtype;
    both round to nearest even, so the two inputs are equal."""
    return jnp.asarray(x, dtype=jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


# ----------------------------------------------------------- flash attention
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 4, 4, 128, 32),      # MHA
    (2, 8, 2, 256, 64),      # GQA 4:1
    (1, 8, 1, 128, 64),      # MQA
    (2, 4, 4, 192, 16),      # non-pow2 seq
])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_flash_attention_shapes(b, hq, hkv, s, d, dtype, backend):
    jdt, tdt, tol = DTYPES[dtype]
    qn, kn, vn = _normal(0, (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))
    (qj, qt), (kj, kt), (vj, vt) = (_both(x, jdt, tdt) for x in (qn, kn, vn))
    want = ref_flash_attention(qj, kj, vj, causal=True, backend=backend,
                               block_q=64, block_k=64)
    got = flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == tdt and tuple(got.shape) == (b, hq, s, d)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_flash_attention_masks(causal, window, backend):
    qn, kn, vn = _normal(1, (1, 2, 128, 32), (1, 2, 128, 32),
                         (1, 2, 128, 32))
    want = ref_flash_attention(jnp.asarray(qn), jnp.asarray(kn),
                               jnp.asarray(vn), causal=causal, window=window,
                               backend=backend, block_q=32, block_k=32)
    got = flash_attention(torch.from_numpy(qn), torch.from_numpy(kn),
                          torch.from_numpy(vn), causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("sq,sk,window", [(100, 100, 0), (37, 37, 8),
                                          (20, 50, 0)])
def test_flash_attention_ragged_and_strided(sq, sk, window):
    """Lengths the Pallas kernel's block asserts refuse, held against the
    XLA oracle, through transposed (B, S, H, D) views as the model passes
    them."""
    qn, kn, vn = _normal(2, (2, sq, 4, 16), (2, sk, 2, 16), (2, sk, 2, 16))
    want = ref_flash_attention(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (qn, kn, vn)),
        causal=True, window=window, backend="xla")
    q, k, v = (torch.from_numpy(x).transpose(1, 2) for x in (qn, kn, vn))
    got = flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


# ----------------------------------------------------------- decode attention
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (2, 4, 4, 512, 32),
    (3, 8, 2, 1024, 64),
    (1, 8, 1, 256, 64),
])
@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_attention_shapes(b, hq, hkv, s, d, backend):
    qn, kn, vn = _normal(3, (b, hq, d), (b, hkv, s, d), (b, hkv, s, d))
    lens = np.array([s - i * 7 for i in range(b)], np.int32)
    want = ref_decode_attention(jnp.asarray(qn), jnp.asarray(kn),
                                jnp.asarray(vn), lengths=jnp.asarray(lens),
                                backend=backend, block_k=128)
    got = decode_attention(torch.from_numpy(qn), torch.from_numpy(kn),
                           torch.from_numpy(vn),
                           lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("q_dtype,cache_dtype", [("bfloat16", "float32"),
                                               ("float32", "bfloat16")])
@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_attention_mixed_dtypes(q_dtype, cache_dtype, backend):
    """q in one type over a cache in another (a bfloat16 model over the
    engine's default float32 cache): both read as float32, the output in
    q's type."""
    qn, kn, vn = _normal(6, (2, 8, 32), (2, 2, 96, 32), (2, 2, 96, 32))
    lens = np.array([96, 41], np.int32)
    (qjdt, qtdt, tol), (kjdt, ktdt, _) = DTYPES[q_dtype], DTYPES[cache_dtype]
    qj, qt = _both(qn, qjdt, qtdt)
    (kj, kt), (vj, vt) = _both(kn, kjdt, ktdt), _both(vn, kjdt, ktdt)
    want = ref_decode_attention(qj, kj, vj, lengths=jnp.asarray(lens),
                                backend=backend, block_k=32)
    got = decode_attention(qt, kt, vt, lengths=torch.from_numpy(lens))
    assert got.dtype == qtdt and want.dtype == qjdt
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


def test_decode_attention_respects_lengths():
    """Tokens beyond ``length`` do not affect the output."""
    qn, kn, vn = _normal(4, (1, 2, 16), (1, 1, 64, 16), (1, 1, 64, 16))
    lens = np.array([40], np.int32)
    base = decode_attention(torch.from_numpy(qn), torch.from_numpy(kn),
                            torch.from_numpy(vn),
                            lengths=torch.from_numpy(lens))
    kn2, vn2 = kn.copy(), vn.copy()
    kn2[:, :, 50:] = 99.0
    vn2[:, :, 50:] = -99.0
    pert = decode_attention(torch.from_numpy(qn), torch.from_numpy(kn2),
                            torch.from_numpy(vn2),
                            lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(_np(base), _np(pert), atol=1e-6)
    want = ref_decode_attention(jnp.asarray(qn), jnp.asarray(kn2),
                                jnp.asarray(vn2), lengths=jnp.asarray(lens),
                                backend="pallas", block_k=32)
    np.testing.assert_allclose(_np(pert), _np(want), atol=2e-5)


def test_cpu_tensors_never_launch():
    """On CPU tensors the wrappers run their plain versions: no launch."""
    before = (dict(fa_kernel.launches), dict(dec_kernel.launches))
    qn, kn = _normal(5, (1, 2, 8, 16), (1, 1, 8, 16))
    q, k = torch.from_numpy(qn), torch.from_numpy(kn)
    flash_attention(q, k, k)
    decode_attention(q[:, :, 0], k, k)
    assert (fa_kernel.launches, dec_kernel.launches) == before


def test_wrappers_check_shapes():
    q = torch.zeros((1, 3, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="one shape"):
        decode_attention(q[:, :2, 0], k, k[:, :, :4])
