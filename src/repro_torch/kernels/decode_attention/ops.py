"""Public decode-attention op of the port.

The reference's op (``repro/kernels/decode_attention/ops.py``) picks a
backend by argument. The port has no backend switch:
:func:`decode_attention` dispatches on its tensors' device, to the CUDA
kernel for CUDA tensors (or an exception) and to the plain version
(``ref.py``) for CPU tensors.

Contract: q (B, Hq, D) holds one query token per sequence, k and v
(B, Hkv, S, D) the cache, Hq a multiple of Hkv; ``lengths`` (B,) int32
counts the valid cache positions of each sequence (all S if omitted).
On CUDA, ``lengths`` must be >= 1: with a length of 0 the kernel returns
zeros, as the Pallas kernel does, while the plain version returns the
mean of V. The only caller (``models/attention.py::attn_decode``) passes
at least 1, and the wrapper adds no device-to-host sync to check it.
"""
from repro_torch.kernels.decode_attention.kernel import decode_attention

__all__ = ["decode_attention"]
