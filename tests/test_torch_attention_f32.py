"""Flash attention's float32 path on the CPU: the rule that picks K2's
kernel, and the split-TF32 arithmetic of its float32 tensor-core kernel.

``csrc/flash_attention.cu``'s ``flash_attention_f32tc_kernel`` runs only
on a card. Its arithmetic is emulated here in plain torch, as the kernel
does it: each operand split into two TF32 numbers (``hi``: the float32
bits rounded to 10 mantissa bits by adding 0x1000 and clearing the low
13; ``lo = x - hi`` with its low 13 bits cleared, as the tensor cores
read it), three products per multiply-add (lo·hi + hi·lo + hi·hi, summed
in float32), for S = Q Kᵀ and for O += P V, over the kernel's key tiles
with its online softmax. Seeded NumPy inputs go through the emulation
and through the reference's ``flash_attention`` XLA oracle, held at the
reference's float32 ``atol=2e-5`` (``tests/test_kernels.py:47``) at the
head dims of the training shapes (64, 80, 128, MLA's 192 with v padded
from 128, 256) and the three mask kinds. One TF32 product (``hi`` alone)
misses that bar, which shows the bar can tell them apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    flash_attention as ref_flash_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                      attention_mask)

ATOL = 2e-5
MASKS = [(True, 0), (True, 24), (False, 0)]   # causal, window, neither
LOW_13 = ~0x1FFF                              # clears the bits past TF32


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``hi``: x rounded to TF32, half away from zero, on its bits."""
    return ((x.view(torch.int32) + 0x1000) & LOW_13).view(torch.float32)


def _tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor cores read a float32 register as TF32."""
    return (x.view(torch.int32) & LOW_13).view(torch.float32)


def _matmul_split(a: torch.Tensor, b: torch.Tensor,
                  terms: int = 3) -> torch.Tensor:
    """a @ b from TF32 halves: lo·hi + hi·lo + hi·hi (``terms`` 3), or
    hi·hi alone (``terms`` 1); each product of two TF32 numbers is exact
    in float32, the sums are float32."""
    ah, bh = _tf32_round(a), _tf32_round(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32_truncate(a - ah), _tf32_truncate(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def split_tf32_attention(q, k, v, causal, window, terms=3):
    """The split-TF32 kernel's arithmetic on (B, H, S, D) float32 CPU
    tensors: its key tiles (32 keys up to D 128, 16 above), its masks at
    -1e30, its online softmax in float32 with exp, and its output
    acc / max(l, 1e-30)."""
    b, hq, sq, d = q.shape
    sk, group = k.shape[2], hq // k.shape[1]
    kx, vx = (t.repeat_interleave(group, dim=1) for t in (k, v))
    bk = 32 if d <= 128 else 16
    mask = attention_mask(sq, sk, causal=causal, window=window)
    m = torch.full((b, hq, sq), NEG_INF)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, sk, bk):
        s = _matmul_split(q, kx[:, :, k0:k0 + bk].transpose(-1, -2),
                          terms) * d ** -0.5
        s = torch.where(mask[:, k0:k0 + bk], s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _matmul_split(
            p, vx[:, :, k0:k0 + bk], terms)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def _inputs(d, v_dim, seed, b=1, hq=4, hkv=2, s=80):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = np.zeros((b, hkv, s, d), np.float32)
    v[..., :v_dim] = rng.standard_normal((b, hkv, s, v_dim))
    return q, k, v


def _oracle(q, k, v, causal, window):
    return np.asarray(ref_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, backend="xla"), dtype=np.float32)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("d,v_dim", [(64, 64), (80, 80), (128, 128),
                                     (192, 128), (256, 256)])
def test_split_tf32_holds_the_float32_bar(d, v_dim, causal, window):
    """Ragged S 80 against tiles of 32 or 16 keys, GQA 4/2."""
    q, k, v = _inputs(d, v_dim, seed=d + window + int(causal))
    got = split_tf32_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal, window).numpy()
    want = _oracle(q, k, v, causal, window)
    assert np.abs(got - want).max() <= ATOL
    assert np.all(got[..., v_dim:] == 0.0)      # MLA's padded columns


@pytest.mark.parametrize("d", [128, 256])
def test_one_tf32_product_misses_the_float32_bar(d):
    q, k, v = _inputs(d, d, seed=3)
    one = split_tf32_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               True, 0, terms=1).numpy()
    assert np.abs(one - _oracle(q, k, v, True, 0)).max() > ATOL


# ------------------------------------------------------------ the rule
def _qkv(dtype, d, s=32, hq=8, hkv=2):
    return (torch.zeros((2, hq, s, d), dtype=dtype),
            torch.zeros((2, hkv, s, d), dtype=dtype),
            torch.zeros((2, hkv, s, d), dtype=dtype))


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 256, "tc"),
    (torch.bfloat16, 24, "simt"),      # not a multiple of 16
    (torch.float32, 16, "f32tc"),      # lm_train (a)'s reduced granite
    (torch.float32, 24, "f32tc"),      # reduced MLA
    (torch.float32, 64, "f32tc"),
    (torch.float32, 80, "f32tc"),
    (torch.float32, 192, "f32tc"),
    (torch.float32, 256, "f32tc"),
    (torch.float32, 20, "simt"),       # not a multiple of 8
    (torch.float32, 264, "simt"),      # past MAX_HEAD_DIM
])
def test_which_kernel_by_type_and_head_dim(dtype, d, kernel):
    assert fa_kernel.which_kernel(*_qkv(dtype, d)) == kernel
    assert fa_kernel.takes_tensor_cores(*_qkv(dtype, d)) == (kernel == "tc")


def test_which_kernel_needs_one_type():
    q, k, v = _qkv(torch.float32, 64)
    assert fa_kernel.which_kernel(q, k, v.bfloat16()) == "simt"
    assert fa_kernel.which_kernel(q.bfloat16(), k.bfloat16(),
                                  v.bfloat16()) == "tc"


@pytest.mark.parametrize("dtype,kernel", [(torch.float32, "f32tc"),
                                          (torch.bfloat16, "tc")])
def test_which_kernel_reads_transposed_views(dtype, kernel):
    """The model's (B, S, H, D) projections viewed as (B, H, S, D)."""
    q = torch.zeros((2, 40, 8, 64), dtype=dtype).transpose(1, 2)
    k = torch.zeros((2, 40, 2, 64), dtype=dtype).transpose(1, 2)
    assert fa_kernel.which_kernel(q, k, k) == kernel


@pytest.mark.parametrize("width,offset,kernel", [
    (68, 0, "f32tc"),    # rows of 272 bytes: every row 16-byte aligned
    (68, 1, "simt"),     # the base 4 bytes off
    (66, 0, "simt"),     # rows of 264 bytes: rows past the first are not
    (72, 4, "f32tc"),    # 16 bytes in, rows of 288 bytes
])
def test_which_kernel_needs_16_byte_alignment_in_float32(width, offset,
                                                         kernel):
    q, k, v = (torch.zeros((1, 4, 32, width)) for _ in range(3))
    view = [t[..., offset:offset + 64] for t in (q, k, v)]
    assert fa_kernel.which_kernel(*view) == kernel


def test_which_kernel_needs_a_dense_last_dim():
    q, k, v = _qkv(torch.float32, 64)
    assert fa_kernel.which_kernel(q[..., ::2], k[..., ::2],
                                  v[..., ::2]) == "simt"
