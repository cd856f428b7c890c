"""Public flash-attention op of the port.

The reference's op (``repro/kernels/flash_attention/ops.py``) picks a
backend by argument (the XLA oracle or the Pallas kernel). The port has
no backend switch: :func:`flash_attention` dispatches on its tensors'
device, to the CUDA kernels for CUDA tensors (bfloat16 on ``wgmma``,
float32 in split TF32 on ``mma.sync``, or the SIMT one, by
``kernel.which_kernel``; or an exception) and to the plain version
(``ref.py``) for CPU tensors.

Contract: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D) with Hq a multiple
of Hkv; ``causal`` masks keys after the query (positions from 0),
``window`` > 0 keeps only the ``window`` latest keys, ``causal=False,
window=0`` is bidirectional. Any Sq and Sk (the Pallas kernel wants
multiples of its 128-row blocks). ``scale`` defaults to ``D ** -0.5``;
in bfloat16 the plain version, like the reference's oracle, rounds it to
bfloat16 first (equal for D = 16, 64 and 256). The op is differentiable
in q, k and v: on CUDA tensors its backward is the plain version's
gradient, recomputed from the saved inputs (``kernel.py`` says why).
"""
from repro_torch.kernels.flash_attention.kernel import flash_attention

__all__ = ["flash_attention"]
