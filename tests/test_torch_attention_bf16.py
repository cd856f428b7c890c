"""Flash attention's bfloat16 path on the CPU: the arithmetic of K2's
``wgmma`` kernel, the rule that routes to it, and the stage-split edits
``chip_ab_flash_attention.py --diagnose`` makes to its source.

``csrc/flash_attention.cu``'s ``flash_attention_tc_kernel`` runs only on a
card. Its arithmetic is emulated here in plain torch, as the kernel does
it: bfloat16 operands whose products are exact in float32 and summed in
float32 (S = Q Kᵀ and O += P V on the tensor cores), the online softmax
in the log2 domain (the row max of the raw logits scaled by c = scale ·
log2 e, P = 2^(s c − m) in one FMA, masked logits at −inf, m from
−1e30), and P entering P V as two bfloat16 terms (its rounding and the
rounded remainder), over the kernel's key tiles (128 keys up to D 128, 64 above)
in its order: per 128-row query block, from the first tile some row of
the block can see. Seeded NumPy inputs go through the emulation and the
reference's ``flash_attention`` XLA oracle, held at the reference's
bfloat16 ``atol=2e-2`` (``tests/test_kernels.py:31``) at D 64, 80, 128,
MLA's 192 (v padded from 128) and 256, and the three mask kinds. Against
a float64 attention of the same bfloat16 inputs, the two terms hold the
output to float32's order where one term would not. A row that sees no
key (a window with Sq > Sk + window - 1) comes out 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_ab_flash_attention as chip_ab_fa
from repro.kernels.flash_attention.ops import \
    flash_attention as ref_flash_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                      attention_mask)

ATOL = 2e-2
MASKS = [(True, 0), (True, 24), (False, 0)]   # causal, window, neither
LOG2E = 1.4426950408889634
# the kernel's query rows a block (kBQ in csrc/flash_attention.cu)
BLOCK_Q = 128


def key_tile(d):
    """Keys a tile (``Geo<NP, TAIL>::kBK`` in the source): 128 up to 128
    columns, 64 above; D 80 is a 64-column panel and a 16-column tail,
    any other D the 64-column panels that cover it."""
    cols = 80 if d == 80 else -(-d // 64) * 64
    return 128 if cols <= 128 else 64


def tc_attention(q, k, v, causal, window, terms=2):
    """The bfloat16 kernel's arithmetic on (B, H, S, D) bfloat16 CPU
    tensors at its default scale d ** -0.5; float32 before the output's
    rounding to bfloat16."""
    b, hq, sq, d = q.shape
    sk, group = k.shape[2], hq // k.shape[1]
    qf = q.float()
    kx, vx = (t.repeat_interleave(group, dim=1).float() for t in (k, v))
    bk = key_tile(d)
    c = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    masked = torch.tensor(-float("inf"))
    mask = attention_mask(sq, sk, causal=causal, window=window)
    out = torch.zeros((b, hq, sq, d))
    for q0 in range(0, sq, BLOCK_Q):
        rows = slice(q0, q0 + BLOCK_Q)
        n = min(sq, q0 + BLOCK_Q) - q0
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        k_hi = min(sk, q0 + BLOCK_Q) if causal else sk
        m = torch.full((b, hq, n), NEG_INF)
        l = torch.zeros((b, hq, n))
        acc = torch.zeros((b, hq, n, d))
        for k0 in range(k_lo // bk * bk, k_hi, bk):
            s = qf[:, :, rows] @ kx[:, :, k0:k0 + bk].transpose(-1, -2)
            s = torch.where(mask[rows, k0:k0 + bk], s, masked)
            m_new = torch.maximum(m, s.amax(dim=-1) * c)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * c - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            hi = p.bfloat16().float()
            pv = hi @ vx[:, :, k0:k0 + bk]
            if terms == 2:
                pv = pv + (p - hi).bfloat16().float() @ vx[:, :, k0:k0 + bk]
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out


def _inputs(d, v_dim, seed, b=1, hq=4, hkv=2, s=300):
    """bfloat16 values (as float32 NumPy arrays); v zero past v_dim."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, s, d)).astype(np.float32)
            for h in (hq, hkv))
    v = np.zeros((b, hkv, s, d), np.float32)
    v[..., :v_dim] = rng.standard_normal((b, hkv, s, v_dim))
    return tuple(torch.from_numpy(x).bfloat16().float().numpy()
                 for x in (q, k, v))


def _oracle(q, k, v, causal, window):
    bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    return np.asarray(ref_flash_attention(
        *bf, causal=causal, window=window, scale=q.shape[-1] ** -0.5,
        backend="xla").astype(jnp.float32))


def _emulate(q, k, v, causal, window, terms=2):
    return tc_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                        causal, window, terms)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("d,v_dim", [(64, 64), (80, 80), (128, 128),
                                     (192, 128), (256, 256)])
def test_tc_arithmetic_holds_the_bf16_bar(d, v_dim, causal, window):
    """Ragged S 300 against tiles of 128 or 64 keys and 128-row blocks,
    GQA 4/2."""
    q, k, v = _inputs(d, v_dim, seed=d + window + int(causal))
    got = _emulate(q, k, v, causal, window).bfloat16().float().numpy()
    want = _oracle(q, k, v, causal, window)
    assert np.abs(got - want).max() <= ATOL
    assert np.all(got[..., v_dim:] == 0.0)      # MLA's padded columns


def _exact(q, k, v, causal, window):
    """Attention of the same values in float64."""
    qd, kd, vd = (torch.from_numpy(x).double() for x in (q, k, v))
    group = qd.shape[1] // kd.shape[1]
    kd, vd = (t.repeat_interleave(group, dim=1) for t in (kd, vd))
    s = qd @ kd.transpose(-1, -2) * q.shape[-1] ** -0.5
    mask = attention_mask(q.shape[2], k.shape[2], causal=causal,
                          window=window)
    s = torch.where(mask, s, torch.tensor(-1e300, dtype=torch.float64))
    return (torch.softmax(s, dim=-1) @ vd).numpy()


@pytest.mark.parametrize("d", [64, 128, 256])
def test_two_p_terms_hold_the_output_to_float32_order(d):
    """Before the output's bfloat16 rounding: two terms within 2e-5 of
    float64, one bfloat16 P (off by up to 2^-9) not."""
    q, k, v = _inputs(d, d, seed=5 + d)
    want = _exact(q, k, v, True, 0)
    two = _emulate(q, k, v, True, 0).numpy()
    one = _emulate(q, k, v, True, 0, terms=1).numpy()
    assert np.abs(two - want).max() <= 2e-5
    assert np.abs(one - want).max() > 2e-5


@pytest.mark.parametrize("d,causal", [(64, True), (80, False),
                                     (256, True)])
def test_rows_that_see_no_key_come_out_zero(d, causal):
    """Sq 400 over Sk 150 with a window of 40: rows from 189 on see no key
    (the block of rows 128-255 holds both kinds, the blocks after it only
    such rows); they come out 0, the rest hold the oracle."""
    sq, sk, window = 400, 150, 40
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 4, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, sk, d)).astype(np.float32)
            for _ in range(2))
    q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
               for x in (q, k, v))
    got = _emulate(q, k, v, causal, window).bfloat16().float().numpy()
    seen = sk + window - 1
    assert np.all(got[:, :, seen:] == 0.0)
    want = _oracle(q, k, v, causal, window)
    assert np.abs(got[:, :, :seen] - want[:, :, :seen]).max() <= ATOL


# --------------------------------------------------------------- the rule
@pytest.mark.parametrize("scale,kernel", [(None, "tc"), (0.125, "tc"),
                                          (0.0, "simt"), (-0.125, "simt"),
                                          (float("nan"), "simt")])
def test_which_kernel_takes_only_a_positive_scale_to_wgmma(scale, kernel):
    """The kernel takes the row max before scaling, so only a positive
    scale keeps it the scaled max; the SIMT kernel takes any other."""
    q, k, v = (torch.zeros((1, h, 32, 64), dtype=torch.bfloat16)
               for h in (4, 2, 2))
    assert fa_kernel.which_kernel(q, k, v, scale) == kernel
    assert fa_kernel.takes_tensor_cores(q, k, v, scale) == (kernel == "tc")


# ------------------------------------------------- the diagnosis's edits
@pytest.mark.parametrize("variant", sorted(chip_ab_fa.VARIANTS))
def test_diagnose_edits_apply_to_the_kernel_source(variant):
    """Each stage-split variant's edits match the source once, so that
    ``--diagnose`` builds it (it fails where one does not match)."""
    src = fa_kernel.SOURCE.read_text()
    edited = chip_ab_fa.variant_sources(src)[variant]
    assert edited != src and "flash_attention_tc_kernel" in edited
