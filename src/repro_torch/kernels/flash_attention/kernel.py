"""Build, binding and launch of the flash-attention CUDA kernel
(``csrc/flash_attention.cu``).

``flash_attention`` replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::_fa_kernel`` (launched by
``flash_attention_pallas``). The source's header says what bounds it on
the card and what its design does about it. The library is built and
bound by :mod:`repro_torch.kernels._build`.

The wrapper takes its plain torch version (``ref.py``) only for tensors
on the CPU. For CUDA tensors it launches the kernel on the current
stream or raises: there is no fallback. The kernel reads q, k and v
through their (batch, head, position) strides, so the transposed views
of ``_split_heads`` need no copy; only the last dim must be dense.

The source holds three kernels. :func:`which_kernel` is the one rule
that picks among them, by type, head dim and alignment: bfloat16
operands with a head dim that is a multiple of 16 go to the ``wgmma``
tensor-core kernel (``"tc"``), float32 ones with a head dim that is a
multiple of 8 to the split-TF32 tensor-core kernel (``"f32tc"``), each
with 16-byte-aligned bases and strides (the ``wgmma`` kernel only with
a positive scale); everything else (other head dims, other alignments)
to the SIMT kernel (``"simt"``).
``launches["flash_attention"]`` counts every launch,
``launches["flash_attention_tc"]`` and
``launches["flash_attention_f32tc"]`` those of the two tensor-core
kernels.

**The gradient.** On a CUDA tensor :func:`flash_attention` calls the op
``torch.ops.repro_torch.flash_attention``, whose forward launches the
kernel and whose backward (registered with ``register_autograd``) is
the op ``torch.ops.repro_torch.flash_attention_backward``: it
recomputes the plain version from the saved q, k and v and returns its
gradients by autograd. Being an op of its own, the backward shards as
the forward does on a mesh (``parallel.sharding.register_op_shardings``)
and the dry run counts it by a formula. That is the gradient the reference
trains with: its Pallas kernel is forward-only,
it has no backward kernel, and ``jax.value_and_grad`` differentiates
its XLA oracle (``repro/models/runtime_flags.py``: ``ATTN_BACKEND`` is
``"xla"``). A hand-written backward kernel is later performance work.
The backward runs only in backward: it is the designed gradient, not a
fallback. Being an op, the attention shows up to selective
checkpointing, so the ``"dots"`` remat policy keeps its output instead
of launching it again (``repro_torch.models.lm._save_dots``). On CPU
tensors :func:`flash_attention` is the plain version, which autograd
differentiates directly; the op itself runs the plain version there
too, which lets the CPU tests hold its backward to that autograd.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import (CudaLibrary, F, I, L, P, check,
                                        check_tensor, launch)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_tc": 0,
                            "flash_attention_f32tc": 0}
# the C entry point's code of each kernel, and its launch counter
KERNEL_CODES = {"simt": 0, "tc": 1, "f32tc": 2}
KERNEL_COUNTERS = {"tc": "flash_attention_tc",
                   "f32tc": "flash_attention_f32tc"}
# calls of the backward op on real tensors (it launches no kernel of its
# own: the plain version's ops)
backward_calls: Dict[str, int] = {"flash_attention_backward": 0}
# the profiler range around the op's backward
BACKWARD_RANGE = "repro_torch::flash_attention_backward"


def reset_launches() -> None:
    for counts in (launches, backward_calls):
        for k in counts:
            counts[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = (
        [P, P, P, P, I, I, I, I, I, I, I] + [L] * 12 + [F, I, I, I, P])
    lib.flash_attention_launch.restype = I
    lib.flash_attention_max_head_dim.restype = I
    lib.flash_attention_tc_map_geometry.argtypes = (
        [I, I, I, I] + [L] * 3 + [I, I, P])
    lib.flash_attention_tc_map_geometry.restype = None
    if lib.flash_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("flash_attention.cu's head-dim limit differs "
                           "from MAX_HEAD_DIM")


LIBRARY = CudaLibrary(SOURCE, _bind)
build = LIBRARY.build


def which_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: Optional[float] = None) -> str:
    """Which kernel takes these operands: ``"tc"`` (bfloat16 on
    ``wgmma``) for three bfloat16 operands with the head dim a multiple
    of 16 and a positive ``scale`` (None is the default d ** -0.5: the
    kernel takes the row max before scaling); ``"f32tc"`` (split TF32 on
    ``mma.sync``) for three float32 ones with the head dim a multiple of
    8; each only up to MAX_HEAD_DIM, with a dense last dim, every base
    16-byte aligned and every (batch, head, position) stride a multiple
    of 16 bytes. ``"simt"`` for the rest. One TF32 product cannot hold
    float32's 2e-5; the split one (three products of TF32 halves) can."""
    d = q.shape[-1]
    dtypes = {t.dtype for t in (q, k, v)}
    if dtypes == {torch.bfloat16}:
        if scale is not None and not scale > 0:
            return "simt"
        name, d_multiple, elts = "tc", 16, 8
    elif dtypes == {torch.float32}:
        name, d_multiple, elts = "f32tc", 8, 4
    else:
        return "simt"
    if d % d_multiple != 0 or d > MAX_HEAD_DIM:
        return "simt"
    aligned = all(t.stride(-1) == 1 and t.data_ptr() % 16 == 0
                  and all(st % elts == 0 for st in t.stride()[:3])
                  for t in (q, k, v))
    return name if aligned else "simt"


def takes_tensor_cores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: Optional[float] = None) -> bool:
    """Whether the bfloat16 ``wgmma`` kernel takes these operands
    (:func:`which_kernel` gives ``"tc"``)."""
    return which_kernel(q, k, v, scale) == "tc"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, D) over k, v (B, Hkv, Sk, D): GQA, the
    causal / sliding-window / bidirectional masks, any Sq and Sk, float32
    or bfloat16, D <= 256 on the card. Returns (B, Hq, Sq, D) in q's
    dtype, differentiable in q, k and v."""
    check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
          "q, k, v must be (B, H, S, D)")
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    check(tuple(v.shape) == tuple(k.shape), "k and v must have one shape")
    check(k.shape[0] == b and k.shape[3] == d,
          "k, v must match q's batch and head dim")
    check(hkv >= 1 and hq % hkv == 0, "GQA requires Hq % Hkv == 0")
    check(window >= 0, f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return flash_attention_op(q, k, v, causal, window, scale)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int,
                       scale: Optional[float]) -> torch.Tensor:
    """The attention as an op: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return _launch(q, k, v, causal, window, scale)


@flash_attention_op.register_fake
def _(q, k, v, causal, window, scale):
    b, hq, sq, d = q.shape
    return q.new_empty((b, sq, hq, d)).transpose(1, 2)


def _setup_context(ctx, inputs, output) -> None:
    q, k, v, ctx.causal, ctx.window, scale = inputs
    # the scale the forward used: the kernel's exact d ** -0.5 by default
    ctx.scale = scale if scale is not None else q.shape[-1] ** -0.5
    ctx.save_for_backward(q, k, v)


def _backward(ctx, grad: torch.Tensor):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = torch.ops.repro_torch.flash_attention_backward(
        grad, q, k, v, ctx.causal, ctx.window, ctx.scale)
    return dq, dk, dv, None, None, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=())
def flash_attention_backward_op(
        grad: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
        v: torch.Tensor, causal: bool, window: int,
        scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention's gradients (dq, dk, dv) for the output's gradient
    ``grad``: the plain version recomputed from q, k and v and
    differentiated by autograd, on any device (a named range of a
    profiler's trace, which gives its device time)."""
    backward_calls["flash_attention_backward"] += 1
    # an op's body runs below autograd (the dispatcher excludes its keys
    # from here down): let autograd back in to differentiate the plain
    # version, as its caller would
    exclude = (torch._C._dispatch_tls_local_exclude_set()
               - torch._C.DispatchKeySet(
                   torch._C.DispatchKey.AutogradFunctionality))
    with torch.profiler.record_function(BACKWARD_RANGE), \
            torch._C._ForceDispatchKeyGuard(
                torch._C._dispatch_tls_local_include_set(), exclude), \
            torch.enable_grad():
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_ref(q, k, v, causal=causal, window=window,
                                  scale=scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
    return dq, dk, dv


@flash_attention_backward_op.register_fake
def _(grad, q, k, v, causal, window, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, scale: Optional[float]) -> torch.Tensor:
    """The CUDA kernel's launch on validated shapes."""
    dev = q.device
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    check(dev.type == "cuda", f"unsupported device {dev}")
    check(q.dtype in DTYPES, f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, q.dtype, 4, dev, contiguous=False)
    check(1 <= d <= MAX_HEAD_DIM, f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    # the exact d ** -0.5 of the Pallas kernel (ref.default_scale rounds
    # it to bfloat16 for bfloat16 inputs, as the reference's oracle does)
    scale_val = float(scale) if scale is not None else float(d) ** -0.5
    # (B, Sq, Hq, D) storage: the caller's _merge_heads is then a view
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    if out.numel() == 0:
        return out
    which = which_kernel(q, k, v, scale_val)
    launch(launches, "flash_attention", dev,
           LIBRARY.get().flash_attention_launch,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *out.stride()[:3], ctypes.c_float(scale_val), int(causal),
           int(window), KERNEL_CODES[which])
    if which in KERNEL_COUNTERS:
        launches[KERNEL_COUNTERS[which]] += 1
    return out
