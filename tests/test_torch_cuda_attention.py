"""The port's attention kernels and serving path on a CUDA device.

Every test here is marked ``cuda`` and skips without a CUDA device. Each
kernel is held against its plain torch version on the same card and
inputs (bfloat16 ``atol=2e-2``, float32 ``atol=2e-5``, the reference's
tolerances; bfloat16 also within 2e-2 of each output row's largest
value, since a row that averages many keys has values about as small as
the absolute tolerance) over head dims 16, 64, 80, 128, 192 (MLA's
qk_head_dim) and 256, ragged lengths, GQA ratios 1, 4 and 8 (and 10,
recurrentgemma's MQA, in decode) and the three mask kinds, and each test
asserts that
the kernel launched (its counter moved). Flash attention's three kernels
are told apart by ``launches["flash_attention_tc"]`` (the bfloat16
``wgmma`` kernel) and ``launches["flash_attention_f32tc"]`` (the float32
split-TF32 one), the rest being the SIMT kernel's; decode attention's
cache splits are checked at their boundaries, for determinism, and
under CUDA-graph capture. This file
imports only the port, NumPy and torch, so it runs on a machine without
JAX::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_attention.py
"""
import ctypes
import dataclasses

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
@pytest.mark.parametrize("d", [16, 64, 80, 128, 192, 256])
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


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 16, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 80, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 256, "tc"),
    # float32: split TF32 (three TF32 products) holds 2e-5, one would not
    (torch.float32, 64, "f32tc"),
    (torch.float32, 24, "f32tc"),      # a multiple of 8 (reduced MLA)
    (torch.float32, 20, "simt"),       # not a multiple of 8
    (torch.bfloat16, 24, "simt"),      # not a multiple of 16
])
def test_flash_attention_dispatch(dev, dtype, d, kernel):
    """bfloat16 with D a multiple of 16 takes the ``wgmma`` kernel,
    float32 with D a multiple of 8 the split-TF32 kernel; other head
    dims take the SIMT kernel."""
    q, k, v = _normal(dev, d, dtype, (2, 8, 150, d), (2, 2, 150, d),
                      (2, 2, 150, d))
    assert fa_kernel.which_kernel(q, k, v) == kernel
    assert fa_kernel.takes_tensor_cores(q, k, v) == (kernel == "tc")
    before = dict(fa_kernel.launches)
    got = fa_kernel.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize(dev)
    assert fa_kernel.launches["flash_attention"] == \
        before["flash_attention"] + 1
    assert fa_kernel.launches["flash_attention_tc"] == \
        before["flash_attention_tc"] + int(kernel == "tc")
    assert fa_kernel.launches["flash_attention_f32tc"] == \
        before["flash_attention_f32tc"] + int(kernel == "f32tc")
    _assert_close(got, flash_attention_ref(q, k, v, causal=True,
                                           scale=float(d) ** -0.5))


# K2's float32 training shapes (B cut to 1): (Hq, Hkv, Sq, Sk, D, v_dim,
# causal, window); granite's GQA 32/8, hubert's bidirectional D 80,
# moonshot's D 128, MLA's D 192 (v padded from 128), recurrentgemma's
# 10/1 D 256 window 2048, danube's heads with a window of 128, the D 256
# shape at S 512; then ragged Sq and Sk and a window of 16
F32_TRAIN_SHAPES = [
    (32, 8, 256, 256, 64, 64, True, 0),
    (16, 16, 256, 256, 80, 80, False, 0),
    (16, 16, 256, 256, 128, 128, True, 0),
    (128, 128, 256, 256, 192, 128, True, 0),
    (10, 1, 256, 256, 256, 256, True, 2048),
    (32, 8, 256, 256, 80, 80, True, 128),
    (10, 1, 512, 512, 256, 256, True, 2048),
    (32, 8, 100, 100, 64, 64, True, 16),
    (10, 1, 77, 77, 256, 256, True, 16),
    (16, 16, 37, 300, 128, 128, True, 0),
    (32, 8, 130, 70, 80, 80, False, 0),
    (128, 128, 45, 45, 192, 128, True, 16),
]


@pytest.mark.parametrize("hq,hkv,sq,sk,d,v_dim,causal,window",
                         F32_TRAIN_SHAPES)
def test_flash_attention_split_tf32_at_the_training_shapes(
        dev, hq, hkv, sq, sk, d, v_dim, causal, window):
    """The split-TF32 kernel against the plain version in float32 at
    ``2e-5``: each training shape's heads, ragged lengths and windows;
    MLA's padded columns exactly 0; its counter moved."""
    q, k, v = _normal(dev, d + hq + sq, torch.float32, (1, hq, sq, d),
                      (1, hkv, sk, d), (1, hkv, sk, v_dim))
    v = torch.nn.functional.pad(v, (0, d - v_dim))
    assert fa_kernel.which_kernel(q, k, v) == "f32tc"
    before = dict(fa_kernel.launches)
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize(dev)
    assert fa_kernel.launches["flash_attention_f32tc"] == \
        before["flash_attention_f32tc"] + 1
    assert fa_kernel.launches["flash_attention"] == \
        before["flash_attention"] + 1
    _assert_close(got, flash_attention_ref(q, k, v, causal=causal,
                                           window=window,
                                           scale=float(d) ** -0.5))
    assert bool((got[..., v_dim:] == 0).all())


def test_flash_attention_tensor_cores_take_misaligned_views_to_simt(dev):
    """A view whose base breaks 16-byte alignment goes to the SIMT
    kernel, by the one rule, and still agrees with the plain version."""
    q, k, v = _normal(dev, 3, torch.bfloat16, (1, 4, 64, 65),
                      (1, 2, 64, 65), (1, 2, 64, 65))
    q, k, v = (t[..., 1:] for t in (q, k, v))   # D 64, odd strides
    assert not fa_kernel.takes_tensor_cores(q, k, v)
    before = fa_kernel.launches["flash_attention_tc"]
    got = fa_kernel.flash_attention(q, k, v, causal=True)
    assert fa_kernel.launches["flash_attention_tc"] == before
    _assert_close(got, flash_attention_ref(q, k, v, causal=True))


@pytest.mark.parametrize("window", [0, 512])
def test_flash_attention_tensor_cores_at_scale(dev, window):
    """Granite's prefill length: 32 key tiles wrap the 2-stage ring many
    times, and the diagonal / window-edge tiles take the masked path
    while the interior ones do not."""
    q, k, v = _normal(dev, 21 + window, torch.bfloat16, (1, 8, 2048, 64),
                      (1, 2, 2048, 64), (1, 2, 2048, 64))
    before = fa_kernel.launches["flash_attention_tc"]
    got = fa_kernel.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize(dev)
    assert fa_kernel.launches["flash_attention_tc"] == before + 1
    _assert_close(got, flash_attention_ref(q, k, v, causal=True,
                                           window=window))


@pytest.mark.parametrize("hq,hkv,s,d,causal,window", [
    (10, 1, 4096, 256, True, 2048),     # recurrentgemma's local attention
    (8, 1, 2048, 256, True, 0),         # paligemma's MQA
    (16, 16, 2048, 80, False, 0)])      # hubert: two panels, 48 zero cols
def test_flash_attention_tensor_cores_at_the_families_shapes(
        dev, hq, hkv, s, d, causal, window):
    """The tensor-core kernel at the D 256 (four panels) and D 80 (the
    padded-column path) prefill shapes of the SSM-era families, one batch
    row, at the long-row bar and the row rule: early causal rows average
    few keys, so some outputs reach |4| and more, where one bf16 ulp is
    1/32."""
    q, k, v = _normal(dev, 31 + d, torch.bfloat16, (1, hq, s, d),
                      (1, hkv, s, d), (1, hkv, s, d))
    before = fa_kernel.launches["flash_attention_tc"]
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize(dev)
    assert fa_kernel.launches["flash_attention_tc"] == before + 1
    _assert_close(got, flash_attention_ref(q, k, v, causal=causal,
                                           window=window,
                                           scale=float(d) ** -0.5))


# The bfloat16 prefill and encode shapes of the LM paths, B cut to 1:
# (Hq, Hkv, S, D, v_dim, causal, window): granite (and its window of 512),
# moonshot, internlm2, command-r-plus, MLA (D 192, v padded from 128),
# recurrentgemma (window 2048 at S 2048 and 4096), paligemma, hubert
TC_PATH_SHAPES = [
    (32, 8, 2048, 64, 64, True, 0),
    (32, 8, 2048, 64, 64, True, 512),
    (16, 16, 2048, 128, 128, True, 0),
    (48, 8, 2048, 128, 128, True, 0),
    (96, 8, 2048, 128, 128, True, 0),
    (128, 128, 2048, 192, 128, True, 0),
    (10, 1, 2048, 256, 256, True, 2048),
    (10, 1, 4096, 256, 256, True, 2048),
    (8, 1, 2048, 256, 256, True, 0),
    (16, 16, 2048, 80, 80, False, 0),
]


def _tc_case(dev, seed, q_shape, kv_shape, v_dim=None, causal=True,
             window=0):
    """The ``wgmma`` kernel on seeded operands against the plain version
    (2e-2 and the row rule); its counter moved once; columns past
    ``v_dim`` exactly 0. Returns the output."""
    q, k, v = _normal(dev, seed, torch.bfloat16, q_shape, kv_shape,
                      kv_shape)
    d = q.shape[-1]
    if v_dim is not None:
        v = torch.nn.functional.pad(v[..., :v_dim], (0, d - v_dim))
    assert fa_kernel.which_kernel(q, k, v) == "tc"
    before = dict(fa_kernel.launches)
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize(dev)
    assert fa_kernel.launches["flash_attention_tc"] == \
        before["flash_attention_tc"] + 1
    _assert_close(got, flash_attention_ref(q, k, v, causal=causal,
                                           window=window,
                                           scale=float(d) ** -0.5))
    if v_dim is not None:
        assert bool((got[..., v_dim:] == 0).all())
    return got


@pytest.mark.parametrize("hq,hkv,s,d,v_dim,causal,window", TC_PATH_SHAPES)
def test_tc_kernel_at_the_path_shapes(dev, hq, hkv, s, d, v_dim, causal,
                                      window):
    _tc_case(dev, hq + d + window, (1, hq, s, d), (1, hkv, s, d), v_dim,
             causal, window)


@pytest.mark.parametrize("d", list(range(16, 257, 16)))
def test_tc_kernel_at_every_head_dim(dev, d):
    """Every D the rule sends to the kernel: its panels (and D 80's tail)
    with ragged Sq and Sk past 128-row blocks and key tiles."""
    _tc_case(dev, 100 + d, (2, 4, 200, d), (2, 2, 200, d))
    _tc_case(dev, 200 + d, (1, 4, 150, d), (1, 4, 333, d), causal=False)


@pytest.mark.parametrize("window", [1, 63, 64, 65, 127, 128, 129, 300])
@pytest.mark.parametrize("d", [64, 80, 256])
def test_tc_kernel_at_window_edges(dev, window, d):
    """Windows on both sides of the 64- and 128-key tile boundaries."""
    _tc_case(dev, window + d, (1, 4, 600, d), (1, 2, 600, d),
             window=window)


@pytest.mark.parametrize("sq,sk", [(1, 700), (37, 300), (129, 257),
                                   (300, 130), (128, 128), (5, 1)])
@pytest.mark.parametrize("d,causal", [(80, True), (80, False),
                                      (192, True), (128, False)])
def test_tc_kernel_with_ragged_and_unequal_lengths(dev, sq, sk, d, causal):
    _tc_case(dev, sq + sk + d, (2, 8, sq, d), (2, 2, sk, d), causal=causal)


@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_tc_kernel_reads_transposed_views_through_its_maps(dev, d):
    """(B, S, H, D) projections viewed as (B, H, S, D) without a copy."""
    q, k, v = _normal(dev, d, torch.bfloat16, (2, 300, 8, d),
                      (2, 300, 2, d), (2, 300, 2, d))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    got = fa_kernel.flash_attention(q, k, v, causal=True)
    _assert_close(got, flash_attention_ref(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
        scale=float(d) ** -0.5))


def _map_geometry(lib, d, s, h, b, strides, cols, rows):
    out = (ctypes.c_ulonglong * 11)()
    lib.flash_attention_tc_map_geometry(d, s, h, b, *strides, cols, rows,
                                        out)
    return {"dims": tuple(out[:4]), "strides": tuple(out[4:7]),
            "box": tuple(out[7:])}


def test_tc_map_geometry_of_the_source(dev):
    """The tensor maps the launch encodes: dims (D, S, H, B) innermost
    first, the byte strides of S, H and B, boxes of cols x rows."""
    lib = fa_kernel.LIBRARY.get()
    # (B, S, H, D) = (2, 40, 8, 64) viewed as (B, H, S, D): element
    # strides (S 512, H 64, B 20480)
    assert _map_geometry(lib, 64, 40, 8, 2, (512, 64, 20480), 64, 128) == {
        "dims": (64, 40, 8, 2), "strides": (1024, 128, 40960),
        "box": (64, 128, 1, 1)}
    # D 80's tail: 16-column boxes of a (2, 40, 2, 80) projection
    assert _map_geometry(lib, 80, 40, 2, 2, (160, 80, 6400), 16, 128) == {
        "dims": (80, 40, 2, 2), "strides": (320, 160, 12800),
        "box": (16, 128, 1, 1)}
    # contiguous (1, 4, 100, 128)
    assert _map_geometry(lib, 128, 100, 4, 1, (128, 12800, 51200), 64,
                         64) == {
        "dims": (128, 100, 4, 1), "strides": (256, 25600, 102400),
        "box": (64, 64, 1, 1)}
    # a size-1 H with a 0 stride takes 16 bytes; an empty S becomes 1
    got = _map_geometry(lib, 64, 0, 1, 3, (64, 0, 64), 64, 64)
    assert got["dims"] == (64, 1, 1, 3)
    assert got["strides"] == (128, 16, 128)


@pytest.mark.parametrize("d,causal", [(64, True), (80, False),
                                      (256, True)])
def test_tc_kernel_rows_that_see_no_key_are_zero(dev, d, causal):
    """Sq 600 over Sk 200 with a window of 64: rows from Sk + window - 1
    on see no key, in a block with rows that do and in blocks of their
    own. They come out 0; the rest hold the plain version."""
    sq, sk, window = 600, 200, 64
    q, k, v = _normal(dev, d + sq, torch.bfloat16, (1, 8, sq, d),
                      (1, 2, sk, d), (1, 2, sk, d))
    before = fa_kernel.launches["flash_attention_tc"]
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize(dev)
    assert fa_kernel.launches["flash_attention_tc"] == before + 1
    seen = sk + window - 1
    assert bool((got[:, :, seen:] == 0).all())
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               scale=float(d) ** -0.5)
    _assert_close(got[:, :, :seen], want[:, :, :seen])


@pytest.mark.parametrize("scale", [0.0, -0.125])
def test_tc_rule_sends_a_non_positive_scale_to_simt(dev, scale):
    """The ``wgmma`` kernel takes the row max before scaling; the SIMT
    kernel takes such a scale, held to the plain version."""
    q, k, v = _normal(dev, 3, torch.bfloat16, (1, 4, 200, 64),
                      (1, 2, 200, 64), (1, 2, 200, 64))
    before = dict(fa_kernel.launches)
    got = fa_kernel.flash_attention(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize(dev)
    assert fa_kernel.launches["flash_attention"] == \
        before["flash_attention"] + 1
    assert fa_kernel.launches["flash_attention_tc"] == \
        before["flash_attention_tc"]
    _assert_close(got, flash_attention_ref(q, k, v, causal=True,
                                           scale=scale))


def test_tc_kernel_is_deterministic(dev):
    q, k, v = _normal(dev, 9, torch.bfloat16, (2, 16, 700, 80),
                      (2, 16, 700, 80), (2, 16, 700, 80))
    a = fa_kernel.flash_attention(q, k, v, causal=False)
    b = fa_kernel.flash_attention(q, k, v, causal=False)
    assert torch.equal(a, b)


def test_tc_kernel_in_a_cuda_graph(dev):
    """A graph replay holds the tensor maps (``__grid_constant__``): new
    values copied into the captured buffers give the direct call's
    output."""
    shapes = ((1, 32, 1000, 64), (1, 8, 1000, 64), (1, 8, 1000, 64))
    q, k, v = _normal(dev, 11, torch.bfloat16, *shapes)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fa_kernel.flash_attention(q, k, v, causal=True, window=200)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa_kernel.flash_attention(q, k, v, causal=True, window=200)
    for seed in (12, 13):
        for t, new in zip((q, k, v), _normal(dev, seed, torch.bfloat16,
                                             *shapes)):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize(dev)
        assert torch.equal(out, fa_kernel.flash_attention(
            q, k, v, causal=True, window=200))


# ----------------------------------------------------------- decode attention
# 12: two group tiles; 16/16: moonshot-v1-16b-a3b's MHA decode; 10/1:
# recurrentgemma's MQA (two group tiles, 8 + 2)
@pytest.mark.parametrize("hq,hkv", GQA + [(24, 2), (16, 16), (10, 1)])
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


def _splits(dev, b, hq, hkv, s, d, tc=True):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return dec_kernel.decode_splits(b, hkv, hq // hkv, s, d, sms, tc)


def _boundary_lengths(n, s):
    """Length 1, S, and lengths on the split rule's boundaries and one
    either side: n chunks (one chunk a split) and 2n chunks (two)."""
    c = dec_kernel.CHUNK
    return [1, n * c - 1, n * c, n * c + 1, 2 * n * c - 1, 2 * n * c,
            2 * n * c + 1, s]


def _call(dev, q, k, v, lengths):
    """One counted call; returns the output and the split kernel taken."""
    before = (dec_kernel.launches["decode_attention"],
              dict(dec_kernel.variants))
    got = dec_kernel.decode_attention(q, k, v, lengths=lengths)
    torch.cuda.synchronize(dev)
    assert dec_kernel.launches["decode_attention"] == before[0] + 1
    taken = [n for n, c in dec_kernel.variants.items() if c != before[1][n]]
    assert len(taken) == 1
    return got, taken[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_split_boundaries(dev, dtype):
    """Lengths on a split boundary and one either side of it, length 1
    and length S, with the valid length cut into runs of whole chunks."""
    b, hq, hkv, s, d = 8, 8, 2, 1000, 64
    n = _splits(dev, b, hq, hkv, s, d, dtype == torch.bfloat16)
    assert n > 1
    lengths = torch.tensor(_boundary_lengths(n, s), dtype=torch.int32,
                           device=dev)
    q, k, v = _normal(dev, 31, dtype, (b, hq, d), (b, hkv, s, d),
                      (b, hkv, s, d))
    got = dec_kernel.decode_attention(q, k, v, lengths=lengths)
    _assert_close(got, decode_attention_ref(q, k, v, lengths=lengths))


def test_decode_attention_most_splits(dev):
    """S 8192 at B 1, Hkv 1: the most splits (one block per split)."""
    q, k, v = _normal(dev, 32, torch.bfloat16, (1, 4, 64), (1, 1, 8192, 64),
                      (1, 1, 8192, 64))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rule = dec_kernel.SPLIT_RULES["tensor_core"]
    assert _splits(dev, 1, 4, 1, 8192, 64) == min(
        rule["blocks_per_sm"] * sms, 8192 // rule["min_split"])
    for length in (8192, 5001):
        lengths = torch.tensor([length], dtype=torch.int32, device=dev)
        got = dec_kernel.decode_attention(q, k, v, lengths=lengths)
        _assert_close(got, decode_attention_ref(q, k, v, lengths=lengths))


def test_decode_attention_is_deterministic(dev):
    q, k, v = _normal(dev, 33, torch.bfloat16, (8, 32, 64),
                      (8, 8, 1024, 64), (8, 8, 1024, 64))
    lengths = torch.full((8,), 700, dtype=torch.int32, device=dev)
    first = dec_kernel.decode_attention(q, k, v, lengths=lengths)
    second = dec_kernel.decode_attention(q, k, v, lengths=lengths)
    assert torch.equal(first, second)


def test_decode_attention_in_a_cuda_graph(dev):
    """Captured once, replayed after ``lengths`` changes in place: equal
    to a fresh call, so the wrapper reads no device value on the host."""
    q, k, v = _normal(dev, 34, torch.bfloat16, (4, 8, 64), (4, 2, 1024, 64),
                      (4, 2, 1024, 64))
    lengths = torch.tensor([1024, 3, 500, 129], dtype=torch.int32,
                           device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):      # warm-up off the default stream
        dec_kernel.decode_attention(q, k, v, lengths=lengths)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dec_kernel.decode_attention(q, k, v, lengths=lengths)
    lengths.copy_(torch.tensor([77, 1024, 1, 640], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize(dev)
    fresh = dec_kernel.decode_attention(q, k, v, lengths=lengths)
    assert torch.equal(out, fresh)
    _assert_close(out, decode_attention_ref(q, k, v, lengths=lengths))


# the serving paths' decode heads (Hq, Hkv, D): granite-3-2b,
# moonshot-v1-16b-a3b, internlm2-20b, command-r-plus-104b,
# recurrentgemma-2b, paligemma-3b
PATH_SHAPES = [(32, 8, 64), (16, 16, 128), (48, 8, 128), (96, 8, 128),
               (10, 1, 256), (8, 1, 256)]


@pytest.mark.parametrize("hq,hkv,d", PATH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_path_shapes(dev, dtype, hq, hkv, d):
    """The six path shapes at batch 3 over a 1024 cache: bfloat16 takes
    the tensor-core split kernel, float32 the SIMT one."""
    b, s = 3, 1024
    q, k, v = _normal(dev, 40 + hq + d, dtype, (b, hq, d), (b, hkv, s, d),
                      (b, hkv, s, d))
    lengths = torch.tensor([512, s, 37], dtype=torch.int32, device=dev)
    got, taken = _call(dev, q, k, v, lengths)
    assert taken == ("tensor_core" if dtype == torch.bfloat16 else "simt")
    want = decode_attention_ref(q, k, v, lengths=lengths)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_close(got, want)


@pytest.mark.parametrize("hq", [10, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_d256_split_boundaries(dev, dtype, hq):
    """D 256 at recurrentgemma's and paligemma's groups: length 1, S,
    and lengths on a split boundary and one either side of it."""
    b, hkv, s, d = 8, 1, 1024, 256
    n = _splits(dev, b, hq, hkv, s, d, dtype == torch.bfloat16)
    lengths = torch.tensor(_boundary_lengths(n, s), dtype=torch.int32,
                           device=dev)
    q, k, v = _normal(dev, 50 + hq, dtype, (b, hq, d), (b, hkv, s, d),
                      (b, hkv, s, d))
    got, _ = _call(dev, q, k, v, lengths)
    _assert_close(got, decode_attention_ref(q, k, v, lengths=lengths))


@pytest.mark.parametrize("view,taken", [
    ("offset", "simt"),         # rows one element off 16 bytes: scalar loads
    ("row_stride", "simt"),     # a row stride of D + 1 elements
    ("transposed", "tensor_core"),   # (B, S, Hkv, D) viewed: aligned
])
def test_decode_attention_d256_strided_cache(dev, view, taken):
    """Strided cache views at D 256 and group 10: rows that are not
    16-byte aligned take the SIMT kernel's scalar loads."""
    b, hq, hkv, s, d = 3, 10, 1, 300, 256
    (q,) = _normal(dev, 60, torch.bfloat16, (b, hq, d))
    if view == "transposed":
        big = _normal(dev, 61, torch.bfloat16, (2, b, s, hkv, d))[0]
        k, v = big[0].transpose(1, 2), big[1].transpose(1, 2)
    else:
        big = _normal(dev, 61, torch.bfloat16, (2, b, hkv, s, d + 1))[0]
        lo = 1 if view == "offset" else 0
        k, v = big[0, ..., lo:lo + d], big[1, ..., lo:lo + d]
    lengths = torch.tensor([s, 1, 137], dtype=torch.int32, device=dev)
    got, got_taken = _call(dev, q, k, v, lengths)
    assert got_taken == taken
    _assert_close(got, decode_attention_ref(q, k, v, lengths=lengths))


def test_decode_attention_deterministic_at_recurrentgemma(dev):
    """MQA 10/1 at D 256, batch 8, cache 1024: bit-identical outputs
    from call to call, with other work on the card between them."""
    q, k, v = _normal(dev, 62, torch.bfloat16, (8, 10, 256),
                      (8, 1, 1024, 256), (8, 1, 1024, 256))
    lengths = torch.tensor([512, 1024, 1, 700, 33, 272, 511, 999],
                           dtype=torch.int32, device=dev)
    first, taken = _call(dev, q, k, v, lengths)
    assert taken == "tensor_core"
    for _ in range(3):
        torch.randn((1 << 20,), device=dev).sum()
        assert torch.equal(first, dec_kernel.decode_attention(
            q, k, v, lengths=lengths))


def test_decode_attention_d256_in_a_cuda_graph(dev):
    """Group 10 at D 256 captured once and replayed after ``lengths``
    changes in place (the split bounds come from ``lengths`` on the
    device): equal to a fresh call and to the plain version."""
    q, k, v = _normal(dev, 63, torch.bfloat16, (8, 10, 256),
                      (8, 1, 1024, 256), (8, 1, 1024, 256))
    lengths = torch.full((8,), 512, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        dec_kernel.decode_attention(q, k, v, lengths=lengths)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dec_kernel.variants["tensor_core"]
    with torch.cuda.graph(graph):
        out = dec_kernel.decode_attention(q, k, v, lengths=lengths)
    assert dec_kernel.variants["tensor_core"] == before + 1
    for new in ([1024, 1, 273, 544, 545, 17, 700, 2], [513] * 8):
        lengths.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize(dev)
        assert torch.equal(out, dec_kernel.decode_attention(
            q, k, v, lengths=lengths))
        _assert_close(out, decode_attention_ref(q, k, v, lengths=lengths))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_length_zero_gives_zeros(dev, dtype):
    """As the Pallas kernel: a row with length 0 reads nothing and gives
    zeros (the callers pass lengths >= 1)."""
    q, k, v = _normal(dev, 64, dtype, (2, 10, 256), (2, 1, 64, 256),
                      (2, 1, 64, 256))
    lengths = torch.tensor([0, 64], dtype=torch.int32, device=dev)
    got, _ = _call(dev, q, k, v, lengths)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _assert_close(got[1:], decode_attention_ref(q[1:], k[1:], v[1:],
                                                lengths=lengths[1:]))


@pytest.mark.parametrize("hq,hkv,d,dtype", [
    (10, 1, 256, torch.bfloat16),   # recurrentgemma's heads
    (12, 1, 128, torch.bfloat16),
    (32, 8, 64, torch.bfloat16),    # granite's
    (10, 1, 256, torch.float32),    # the SIMT split
])
def test_decode_attention_partials_follow_split_ranges(dev, hq, hkv, d,
                                                       dtype):
    """The split kernel alone (``launch_parts``) writes the empty partial
    (m = -1e30, l = 0) exactly where ``split_ranges`` gives a split no
    keys, so the host's copy of the rule is the kernel's; the combine
    alone over those partials gives the call's output bit for bit. The
    parts count in ``part_launches``, never in ``launches``."""
    b, s = 6, 1024
    lengths = [0, 1, 16, 17, 300, s]
    q, k, v = _normal(dev, 66, dtype, (b, hq, d), (b, hkv, s, d),
                      (b, hkv, s, d))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    n = _splits(dev, b, hq, hkv, s, d, dtype == torch.bfloat16)
    before = (dict(dec_kernel.launches), dict(dec_kernel.part_launches))
    _, ws = dec_kernel.launch_parts(q, k, v, lens, dec_kernel.SPLIT)
    out, _ = dec_kernel.launch_parts(q, k, v, lens, dec_kernel.COMBINE, ws)
    torch.cuda.synchronize(dev)
    assert dec_kernel.launches == before[0]
    assert dec_kernel.part_launches == {
        name: count + 1 for name, count in before[1].items()}
    ml = ws[:b * hq * n * 2].view(b, hq, n, 2).cpu()
    for row, length in enumerate(lengths):
        empty = torch.tensor([lo == hi for lo, hi
                              in dec_kernel.split_ranges(length, n)])
        assert torch.equal(ml[row, :, :, 0] == -1e30, empty.expand(hq, n))
        assert torch.equal(ml[row, :, :, 1] > 0, ~empty.expand(hq, n))
    assert torch.equal(out, dec_kernel.decode_attention(q, k, v,
                                                        lengths=lens))


def test_decode_attention_split_rule_holds_on_this_card(dev):
    """Every tensor-core instance holds on an SM at once the blocks the
    split rule gives it (capped at ``blocks_per_sm``), as the bind
    checks."""
    lib = dec_kernel.LIBRARY.get()
    cap = dec_kernel.SPLIT_RULES["tensor_core"]["blocks_per_sm"]
    for d, group in dec_kernel.TC_INSTANCES:
        held = lib.decode_attention_tc_blocks_per_sm(d, group)
        assert held >= 1 and min(held, cap) == dec_kernel.tc_blocks_per_sm(d)


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
        assert fa_kernel.launches["flash_attention_tc"] == 0   # float32
        assert fa_kernel.launches["flash_attention_f32tc"] == cfg.n_layers
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


# ------------------------------------------------------ training on the card
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_gradient_is_the_plain_versions(dev, causal, window):
    """K2 with a gradient: the forward launches the kernel once, the
    backward recomputes the plain version, so q, k and v's gradients
    equal the plain version's autograd on the same card exactly."""
    q, k, v, g = _normal(dev, 21, torch.float32, (2, 8, 70, 64),
                         (2, 2, 70, 64), (2, 2, 70, 64), (2, 8, 70, 64))
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = fa_kernel.launches["flash_attention"]
    out = fa_kernel.flash_attention(*qkv, causal=causal, window=window)
    got = torch.autograd.grad(out, qkv, g)
    assert fa_kernel.launches["flash_attention"] == before + 1
    ref_qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_out = flash_attention_ref(*ref_qkv, causal=causal, window=window)
    want = torch.autograd.grad(want_out, ref_qkv, g)
    _assert_close(out.detach(), want_out.detach())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat,per_step", [("none", 1), ("dots", 1),
                                            ("full", 2)])
def test_train_step_launches_per_remat(dev, remat, per_step):
    """Three train steps of reduced granite on the card and on the CPU
    from the same weights, with no warm-up, so every step moves the
    weights. K2 launches once per layer per step; with ``remat="full"``
    the backward's recompute launches it again, with ``"dots"`` its saved
    output is reused. Every step's loss equals the CPU step's at the
    reference's ``rel=1e-5`` and the parameters after the last step at
    its ``atol=1e-5`` (``tests/test_train.py:67-70``); every grad norm at
    ``rel=1e-4`` and each gradient of the first step within ``1e-5``
    plus ``1e-4`` of its largest element, the bar of the CPU tests
    against the reference (``tests/test_torch_train.py``)."""
    from repro_torch.config import (ParallelConfig, RunConfig, ShapeConfig,
                                    TrainConfig)
    from repro_torch.train import (AdamWConfig, TrainState, make_loss_fn,
                                   make_train_step)
    from repro_torch.utils.tree import tree_leaves
    cfg = reduced_config(get_arch("granite-3-2b"))
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 32)),
                "labels": rng.integers(0, cfg.vocab_size, (4, 32))}
               for _ in range(3)]
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", 32, 4, "train"),
                    parallel=ParallelConfig(remat=remat),
                    train=TrainConfig(warmup_steps=0))
    host = build_model(cfg, device="cpu", dtype=torch.float32)
    host.init(torch.Generator().manual_seed(1))
    card = build_model(cfg, device=dev, dtype=torch.float32)
    card.load_state_dict(host.state_dict())
    init = [p.detach().clone() for p in tree_leaves(host.param_tree())]
    out = []
    for model in (host, card):
        step = make_train_step(model, run)
        state = TrainState.init(model.param_tree(), AdamWConfig())
        loss = make_loss_fn(model, run)(batches[0])
        grads = [g.cpu() for g in torch.autograd.grad(
            loss, tree_leaves(state["params"]))]
        before = fa_kernel.launches["flash_attention"]
        metrics = []
        for b in batches:
            state, m = step(state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        launched = fa_kernel.launches["flash_attention"] - before
        out.append((metrics, grads, [p.detach().cpu() for p in
                                     tree_leaves(state["params"])]))
    assert launched == per_step * cfg.n_layers * len(batches)
    (want_m, want_g, want_p), (got_m, got_g, got_p) = out
    for (loss, gnorm), (want_loss, want_gnorm) in zip(got_m, want_m):
        assert loss == pytest.approx(want_loss, rel=1e-5)
        assert gnorm == pytest.approx(want_gnorm, rel=1e-4)
    for g, want in zip(got_g, want_g):
        assert _max_err(g, want) <= 1e-5 + 1e-4 * float(want.abs().max())
    for p, want in zip(got_p, want_p):
        assert _max_err(p, want) <= 1e-5
    # the steps moved the weights by more than the bar
    assert max(_max_err(p, p0) for p, p0 in zip(want_p, init)) > 1e-4


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"])
def test_moe_family_on_cuda(dev, name):
    """The reduced MoE archs on the card against the same weights on the
    CPU: forward and step-by-step decode logits at ``5e-4``, the router's
    aux loss at ``rel=1e-6``, the engine's greedy tokens equal; K2 once
    per layer (float32: split TF32), K3 once per layer per step for moonshot
    and never for MLA's absorbed decode."""
    cfg = reduced_config(get_arch(name))
    cpu = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu.init(torch.Generator().manual_seed(0))
    model = build_model(cfg, device=dev, dtype=torch.float32)
    model.load_state_dict(cpu.state_dict())
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    fa_kernel.reset_launches()
    dec_kernel.reset_launches()
    with torch.inference_mode():
        fwd, aux = model.forward({"tokens": torch.from_numpy(tokens).to(dev)})
        want, want_aux = cpu.forward({"tokens": torch.from_numpy(tokens)})
        assert _max_err(fwd.cpu(), want) <= 5e-4
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
        assert fa_kernel.launches["flash_attention"] == cfg.n_layers
        cache = model.init_cache(2, 16, dtype=torch.float32)
        for t in range(12):
            lg, cache = model.decode_step(
                torch.from_numpy(tokens[:, t]).to(dev), cache,
                torch.full((2,), t, dtype=torch.int32, device=dev))
            assert _max_err(lg.cpu(), want[:, t]) <= 5e-4
    per_step = 0 if cfg.mla is not None else cfg.n_layers
    assert dec_kernel.launches["decode_attention"] == 12 * per_step
    reqs = [([1, 2, 3], 5), ([7, 8], 5)]
    out = [[r.out_tokens for r in ServeEngine(m, cache_len=64).generate(
        [Request(p, n) for p, n in reqs])] for m in (cpu, model)]
    assert out[0] == out[1]


@pytest.mark.parametrize("name,depth", [("mamba2-370m", None),
                                        ("recurrentgemma-2b", 3),
                                        ("paligemma-3b", None),
                                        ("hubert-xlarge", None)])
def test_new_families_on_cuda(dev, name, depth):
    """The reduced SSM, hybrid (3 layers: its local-attention block),
    VLM and audio archs on the card against the same weights on the CPU:
    forward logits (the VLM's with patches, hubert's over frames) and,
    for the decoders, step-by-step decode logits at ``5e-4`` and the
    engine's greedy tokens equal; K2 once per attention block (float32:
    split TF32), K3 once per attention block per step, neither for SSM and
    RG-LRU blocks."""
    cfg = reduced_config(get_arch(name))
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    cpu = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu.init(torch.Generator().manual_seed(0))
    model = build_model(cfg, device=dev, dtype=torch.float32)
    model.load_state_dict(cpu.state_dict())
    n_attn = sum(kind.startswith("attn") for kind in model.kinds)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12))
    batch = {"tokens": tokens}
    if cfg.family.value == "audio":
        batch = {"frames": rng.standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)}
    elif cfg.family.value == "vlm":
        batch["patches"] = rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    fa_kernel.reset_launches()
    dec_kernel.reset_launches()
    with torch.inference_mode():
        fwd, _ = model.forward({k: torch.from_numpy(v).to(dev)
                                for k, v in batch.items()})
        want, _ = cpu.forward({k: torch.from_numpy(v)
                               for k, v in batch.items()})
        assert _max_err(fwd.cpu(), want) <= 5e-4
        assert fa_kernel.launches == {"flash_attention": n_attn,
                                      "flash_attention_tc": 0,
                                      "flash_attention_f32tc": n_attn}
        if not cfg.decoder:
            return
        text = {"tokens": torch.from_numpy(tokens)}
        if cfg.family.value == "vlm":
            text["patches"] = torch.zeros((2, 0, cfg.d_model))
        want, _ = cpu.forward(text)
        cache = model.init_cache(2, 16, dtype=torch.float32)
        for t in range(12):
            lg, cache = model.decode_step(
                torch.from_numpy(tokens[:, t]).to(dev), cache,
                torch.full((2,), t, dtype=torch.int32, device=dev))
            assert _max_err(lg.cpu(), want[:, t]) <= 5e-4
    assert dec_kernel.launches["decode_attention"] == 12 * n_attn
    reqs = [([1, 2, 3], 5), ([7, 8], 5)]
    out = [[r.out_tokens for r in ServeEngine(m, cache_len=64).generate(
        [Request(p, n) for p, n in reqs])] for m in (cpu, model)]
    assert out[0] == out[1]


# ------------------------------------ the reference's own workload shapes
def test_tc_kernel_at_prefill_32k(dev):
    """granite-3-2b's prefill_32k at one row: GQA 32/8, D 64, S 32,768,
    causal. The first and the last 128 query rows of the first and the
    last kv group's heads against all 32,768 keys, at the bfloat16 bar
    and the row rule."""
    s, hq, hkv, d, rows = 32768, 32, 8, 64, 128
    q, k, v = _normal(dev, 70, torch.bfloat16, (1, hq, s, d),
                      (1, hkv, s, d), (1, hkv, s, d))
    before = fa_kernel.launches["flash_attention_tc"]
    got = fa_kernel.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize(dev)
    assert fa_kernel.launches["flash_attention_tc"] == before + 1
    group = hq // hkv
    for g in (0, hkv - 1):
        heads = slice(g * group, (g + 1) * group)
        for lo in (0, s - rows):
            _assert_close(got[:, heads, lo:lo + rows], flash_attention_ref(
                q[:, heads, lo:lo + rows], k[:, g:g + 1], v[:, g:g + 1],
                causal=True, q_offset=lo))


@pytest.mark.parametrize("b,hq,hkv,s,d,lengths,splits", [
    # granite-3-2b's decode_32k at 16 rows: ragged lengths over a 32k cache
    (16, 32, 8, 32768, 64, [32760 - 37 * i for i in range(16)], 2),
    # h2o-danube-1.8b's long_500k: its full 4096-slot ring, D 80, group 4
    (1, 32, 8, 4096, 80, [4096], 33),
    # recurrentgemma-2b's long_500k: its full 2048-slot ring, D 256,
    # group 10
    (1, 10, 1, 2048, 256, [2048], 64)],
    ids=["decode_32k", "danube_long_500k", "recurrentgemma_long_500k"])
def test_decode_attention_at_the_reference_shapes(dev, b, hq, hkv, s, d,
                                                  lengths, splits):
    """K3 at the reference's decode shapes, on the tensor-core split
    kernel at the split counts the rule gives an H100's 132 SMs."""
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert _splits(dev, b, hq, hkv, s, d) == splits
    q, k, v = _normal(dev, 71 + d, torch.bfloat16, (b, hq, d),
                      (b, hkv, s, d), (b, hkv, s, d))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got, taken = _call(dev, q, k, v, lens)
    assert taken == "tensor_core"
    _assert_close(got, decode_attention_ref(q, k, v, lengths=lens))


@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
def test_rope_angles_on_the_card_are_the_hosts(dev, d):
    """The rotary angles at the positions the reference's shapes reach
    are the host's bit for bit (the compiled reference's, which
    ``tests/test_torch_shapes.py`` checks on the CPU), and the rotation
    within float32's rounding of the host's. Computed on the card in
    float32, some frequencies came out an ulp off, and the angle at
    position 524,287 moved by 524,287 such ulps."""
    from repro_torch.models import layers
    pos = torch.tensor([[0, 100, 4095, 32767, 524271, 524287]],
                       dtype=torch.int32)
    host = layers.rope_angles(pos, d, 10000.0)
    assert torch.equal(layers.rope_angles(pos.to(dev), d, 10000.0).cpu(),
                       host)
    (x,) = _normal(dev, 72 + d, torch.float32, (1, 4, 6, d))
    got = layers.apply_rope(x, pos.to(dev), 10000.0).cpu()
    assert _max_err(got, layers.apply_rope(x.cpu(), pos, 10000.0)) <= 1e-6


def test_decode_at_long_positions_matches_the_cpu(dev):
    """Reduced h2o-danube-1.8b at D 80 in float32, the same seeded weights
    and full ring of 8 on the card and on the CPU: 4 steps to position
    524,287, each step's logits within the decode tests' 5e-4 (with the
    frequencies computed on the card, danube's full-width logits were
    0.024 off the CPU's at 524,284)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config(get_arch("h2o-danube-1.8b")),
                              head_dim=80)
    cpu = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu.init(torch.Generator().manual_seed(3))
    model = build_model(cfg, device=dev, dtype=torch.float32)
    model.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(4)
    start = 524284
    cache = cpu.init_cache(2, 64, dtype=torch.float32)
    for layer in cache:
        for name, t in layer.items():
            if name == "length":
                t.fill_(start)
            else:
                t.normal_(generator=g)
    card = [{k: t.to(dev) for k, t in layer.items()} for layer in cache]
    assert card[0]["k"].shape[2] == cfg.sliding_window
    tokens = torch.tensor([5, 77])
    before = dec_kernel.launches["decode_attention"]
    with torch.inference_mode():
        for j in range(4):
            pos = torch.full((2,), start + j, dtype=torch.int32)
            want, cache = cpu.decode_step(tokens, cache, pos)
            got, card = model.decode_step(tokens.to(dev), card, pos.to(dev))
            assert _max_err(got.cpu(), want) <= 5e-4
            tokens = want.argmax(-1)
    assert dec_kernel.launches["decode_attention"] == before + 4 * 2
