"""Plain torch versions of the two GBDT kernels.

They compute exactly what ``csrc/gbdt_infer.cu`` computes, in the same
float32 summation order, so both are bit-identical to NumPy's
``ObliviousGBDT.decision_function``: the tests run them on the CPU, and
``chip_smoke.py`` holds the kernels against them on the card.

The order is NumPy's pairwise summation over the trees of a row
(``contrib.sum(axis=1)`` on a float32 array, :func:`pairwise_sum`); a
plain left fold or ``torch.sum`` differs from it in the last bits, and
the tau gate of the tuner turns such a bit into another decision.
"""
from __future__ import annotations

import torch

# NumPy's pairwise-summation block (PW_BLOCKSIZE in loops_utils.h.src)
PW_BLOCKSIZE = 128
# candidates per gather in gbdt_grid_logits_ref: bounds its (n, chunk, T)
# index and gather tensors
CAND_CHUNK = 8


def pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension in NumPy's pairwise order.

    Below 8 elements: a fold from 0.0. Up to 128: eight accumulators
    over strided slices, combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)),
    then the tail in sequence. Above 128: the sum of both halves, split
    at ``n/2`` rounded down to a multiple of 8.
    """
    n = a.shape[-1]
    if n < 8:
        res = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
        for i in range(n):
            res = res + a[..., i]
        return res
    if n <= PW_BLOCKSIZE:
        m = n - n % 8
        r = a[..., 0:8]
        for i in range(8, m, 8):
            r = r + a[..., i:i + 8]
        res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for i in range(m, n):
            res = res + a[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_sum(a[..., :n2]) + pairwise_sum(a[..., n2:])


def _level_weights(depth: int, device) -> torch.Tensor:
    """Leaf-index weight of each tree level (level 0 is the MSB)."""
    return 1 << torch.arange(depth - 1, -1, -1, device=device)


def gbdt_logits_ref(x: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                    leaf: torch.Tensor, base: float) -> torch.Tensor:
    """(N,) float32 logits ``f32(base) + Σ_t leaf[t, idx_t]`` of the
    (N, F) float32 rows ``x``; ``feat`` (T, D) int32, ``thr`` (T, D)
    float32, ``leaf`` (T, 2**D) float32."""
    n = x.shape[0]
    t, d = feat.shape
    g = x[:, feat.reshape(-1).long()].view(n, t, d)
    bits = (g > thr).long()
    idx = (bits * _level_weights(d, x.device)).sum(dim=2)
    flat = idx + (torch.arange(t, device=x.device) << d)
    contrib = leaf.reshape(-1)[flat]
    return pairwise_sum(contrib) + float(base)


def gbdt_grid_logits_ref(h: torch.Tensor, cfeat: torch.Tensor,
                         thr: torch.Tensor, idx_theta: torch.Tensor,
                         leaf_flat: torch.Tensor) -> torch.Tensor:
    """(n, C) float32 logits, without the base, of every client row of
    ``h`` (n, F_h) against every candidate of a static grid.

    ``cfeat`` (T, D) int32 holds the client-feature index of each split,
    -1 where the split tests a candidate feature; ``idx_theta`` (C, T)
    int32 is each candidate's partial leaf index, offset by the tree's
    base into ``leaf_flat`` (T * 2**D,) float32. Client and candidate
    halves of a leaf index own disjoint bits, so they combine by
    addition.
    """
    n = h.shape[0]
    t, d = cfeat.shape
    is_client = cfeat >= 0
    g = h[:, cfeat.clamp(min=0).reshape(-1).long()].view(n, t, d)
    bits = ((g > thr) & is_client).long()
    idx_c = (bits * _level_weights(d, h.device)).sum(dim=2)      # (n, T)
    theta = idx_theta.long()
    c = theta.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=h.device)
    for k0 in range(0, c, CAND_CHUNK):
        k1 = min(k0 + CAND_CHUNK, c)
        flat = idx_c[:, None, :] + theta[None, k0:k1, :]
        out[:, k0:k1] = pairwise_sum(leaf_flat[flat])
    return out
