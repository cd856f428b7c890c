"""CPU parity of the port's attention ops with the reference's.

The same seeded NumPy inputs go through the port's ops on CPU tensors
(their plain torch versions) and through ``repro``'s ops with
``backend="pallas"`` (the TPU kernels in interpret mode, as
``tests/test_kernels.py`` runs them) and ``backend="xla"`` (the
oracles). Tolerances are the reference tests': float32 ``atol=2e-5``,
bfloat16 ``atol=2e-2`` (``tests/test_kernels.py:32,96``). The file
ends with the kernels' host-side rules, which need no card.
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


# the group and head-dim shapes the tensor-core split kernel was rebuilt
# for, at small size: recurrentgemma-2b's MQA 10/1 and paligemma-3b's
# 8/1 at D 256, a group of 12 at D 128 (command-r-plus-104b's, here
# over one kv head)
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (2, 10, 1, 128, 256),
    (3, 8, 1, 96, 256),
    (2, 12, 1, 128, 128),
])
@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_attention_wide_groups(b, hq, hkv, s, d, backend):
    qn, kn, vn = _normal(7, (b, hq, d), (b, hkv, s, d), (b, hkv, s, d))
    lens = np.array([s - 31 * i for i in range(b)], np.int32)
    want = ref_decode_attention(jnp.asarray(qn), jnp.asarray(kn),
                                jnp.asarray(vn), lengths=jnp.asarray(lens),
                                backend=backend, block_k=32)
    got = decode_attention(torch.from_numpy(qn), torch.from_numpy(kn),
                           torch.from_numpy(vn),
                           lengths=torch.from_numpy(lens))
    assert tuple(got.shape) == (b, hq, d)
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


# ------------------------------------------------------ the kernels' rules
# ``takes_tensor_cores`` sends operands to flash attention's tensor-core
# kernel or to its SIMT one; ``decode_splits`` sizes the decode split
# kernel's grid from the shapes alone. Both are host functions of dtypes,
# shapes, strides and addresses, so they are held here, without a card.
H100_SMS = 132


def _zeros_qkv(dtype, d, s=32):
    return (torch.zeros((2, 8, s, d), dtype=dtype),
            torch.zeros((2, 2, s, d), dtype=dtype),
            torch.zeros((2, 2, s, d), dtype=dtype))


@pytest.mark.parametrize("d", [16, 64, 80, 128, 192, 256])
def test_tensor_cores_take_bf16_head_dims_of_16(d):
    assert fa_kernel.takes_tensor_cores(*_zeros_qkv(torch.bfloat16, d))


@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 64),               # TF32 cannot hold 2e-5
    (torch.bfloat16, 24),              # not a multiple of 16
    (torch.bfloat16, 8),
    (torch.bfloat16, 100),
])
def test_simt_takes_the_rest(dtype, d):
    assert not fa_kernel.takes_tensor_cores(*_zeros_qkv(dtype, d))


def test_tensor_cores_need_every_operand_bf16():
    q, k, v = _zeros_qkv(torch.bfloat16, 64)
    assert not fa_kernel.takes_tensor_cores(q, k, v.float())


def test_tensor_cores_read_transposed_views():
    """The model's (B, S, H, D) projections viewed as (B, H, S, D)."""
    q = torch.zeros((2, 40, 8, 64), dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros((2, 40, 2, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert fa_kernel.takes_tensor_cores(q, k, k)


def test_tensor_cores_need_16_byte_alignment():
    q, k, v = (torch.zeros((1, 4, 32, 72), dtype=torch.bfloat16)
               for _ in range(3))
    # D 64 views: strides of 72 elements (144 bytes) keep every row
    # aligned; an offset of one element does not
    assert fa_kernel.takes_tensor_cores(q[..., :64], k[..., :64],
                                        v[..., :64])
    assert not fa_kernel.takes_tensor_cores(q[..., 1:65], k[..., :64],
                                            v[..., :64])
    q, k, v = (torch.zeros((1, 4, 32, 68), dtype=torch.bfloat16)
               for _ in range(3))
    # strides of 68 elements (136 bytes): rows past the first misalign
    assert not fa_kernel.takes_tensor_cores(q[..., :64], k[..., :64],
                                            v[..., :64])


def test_decode_splits_count_group_tiles():
    """A group above a kernel's head tile takes two blocks per split, so
    it needs half the splits for the same blocks: 16 heads a tensor-core
    block, 8 a SIMT one."""
    s = 1 << 20
    tc = dec_kernel.SPLIT_RULES["tensor_core"]
    one = dec_kernel.decode_splits(1, 1, 16, s, 64, H100_SMS)
    two = dec_kernel.decode_splits(1, 1, 20, s, 64, H100_SMS)
    assert one == tc["blocks_per_sm"] * H100_SMS and two == one // 2
    simt = dec_kernel.SPLIT_RULES["simt"]
    one = dec_kernel.decode_splits(1, 1, 8, s, 64, H100_SMS, False)
    two = dec_kernel.decode_splits(1, 1, 12, s, 64, H100_SMS, False)
    assert one == simt["waves"] * H100_SMS and two == one // 2


def _per_sm(d):
    """Tensor-core split blocks the rule puts on one SM at head dim d."""
    rule = dec_kernel.SPLIT_RULES["tensor_core"]
    return rule["blocks_per_sm_d256" if d > 128 else "blocks_per_sm"]


@pytest.mark.parametrize("tc", [True, False])
@pytest.mark.parametrize("b,hkv,group,s,d", [
    (8, 8, 4, 1024, 64),       # granite's decode path: cache 1024
    (8, 8, 4, 4096, 64),
    (1, 1, 4, 8192, 64),       # the most splits
    (2, 2, 12, 300, 128),      # a group of 12
    (64, 8, 4, 4096, 64),      # enough blocks without splitting
    (4, 8, 4, 100, 64),        # a cache shorter than one split
    (8, 1, 10, 1024, 256),     # recurrentgemma's MQA, D 256
])
def test_decode_splits_reach_the_waves_without_short_splits(b, hkv, group,
                                                            s, d, tc):
    rule = dec_kernel.SPLIT_RULES["tensor_core" if tc else "simt"]
    n = dec_kernel.decode_splits(b, hkv, group, s, d, H100_SMS, tc)
    blocks = b * hkv * -(-group // rule["head_tile"]) * n
    assert n >= 1
    if n > 1:        # a full cache's splits no shorter than the minimum
        assert s // n >= rule["min_split"]
    capped = n == max(1, s // rule["min_split"])
    if tc:           # every block resident at once, none past the room
        room = _per_sm(d) * H100_SMS
        assert blocks <= room or n == 1
        assert blocks + b * hkv * -(-group // 16) > room or capped
    else:            # the intended waves
        assert blocks >= rule["waves"] * H100_SMS or capped


def test_decode_splits_path_shapes():
    """The serving paths' decode shapes (B 8): the tensor-core kernel's
    splits, then the SIMT kernel's (float32)."""
    tc = {(8, 4, 1024, 64): 4, (16, 1, 1024, 128): 2, (8, 6, 1024, 128): 4,
          (8, 12, 1024, 128): 4, (1, 10, 1024, 256): 16,
          (1, 8, 1024, 256): 16, (1, 8, 4096, 256): 16,
          (8, 4, 4096, 64): 4}
    for (hkv, group, s, d), n in tc.items():
        assert dec_kernel.decode_splits(8, hkv, group, s, d, H100_SMS) == n
    for args, n in (((8, 8, 4, 1024), 5), ((8, 8, 4, 4096), 5),
                    ((1, 1, 4, 8192), 64), ((64, 8, 4, 4096), 1),
                    ((4, 8, 4, 100), 1), ((8, 1, 8, 1024), 8),
                    ((8, 8, 12, 1024), 3)):
        assert dec_kernel.decode_splits(*args, 64, H100_SMS, False) == n


def test_decode_splits_depend_on_shapes_only():
    """The same shapes give the same count; the wrapper passes nothing
    else (no lengths): the count takes shapes and the kernel's kind."""
    import inspect
    params = inspect.signature(dec_kernel.decode_splits).parameters
    assert list(params) == ["b", "hkv", "group", "s", "d", "sms",
                            "tensor_cores"]
    assert len({dec_kernel.decode_splits(8, 8, 4, 1024, 64, H100_SMS)
                for _ in range(3)}) == 1


@pytest.mark.parametrize("d,group,n", [
    (64, 4, 33), (128, 1, 33), (128, 12, 33), (256, 8, 16), (256, 10, 16),
    (256, 20, 8), (200, 8, 16), (16, 1, 33),
])
def test_decode_splits_by_head_dim(d, group, n):
    """Blocks of the tensor-core split at B 8, Hkv 1 over a 4096 cache:
    2 an SM up to D 128, 1 above (two 64-key stages of D 256 K and V
    take ~140 KB of shared memory); a group above 16 heads takes two
    blocks a split."""
    assert dec_kernel.decode_splits(8, 1, group, 4096, d, H100_SMS) == n


@pytest.mark.parametrize("length,n_split", [
    (512, 16), (512, 17), (4059, 17), (1, 4), (0, 3), (16, 2), (17, 2),
    (1000, 7), (4096, 1),
])
def test_split_ranges_cut_the_valid_length(length, n_split):
    """The splits tile [0, length) in order, in runs of whole 16-key
    chunks, every split but the trailing empty ones of one size."""
    ranges = dec_kernel.split_ranges(length, n_split)
    assert len(ranges) == n_split
    assert ranges[0][0] == 0 and ranges[-1][1] == length
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2 and lo <= hi
    sizes = [hi - lo for lo, hi in ranges if hi > lo]
    per = sizes[0] if sizes else 0
    assert per % dec_kernel.CHUNK == 0 or len(sizes) == 1
    assert all(size == per for size in sizes[:-1])
    assert len(sizes) == min(n_split, -(-length // per) if per else 0)


def test_blocks_with_work_at_the_path_shapes():
    """Every split of a half-full cache has keys: the grid is busy."""
    n = dec_kernel.decode_splits(8, 1, 8, 1024, 256, H100_SMS)
    assert dec_kernel.blocks_with_work([512] * 8, 1, 8, n) == 8 * 16
    n = dec_kernel.decode_splits(8, 8, 4, 1024, 64, H100_SMS)
    assert dec_kernel.blocks_with_work([512] * 8, 8, 4, n) == 64 * n
    assert dec_kernel.blocks_with_work([0] * 8, 8, 4, n) == 0
    assert dec_kernel.blocks_with_work([512, 1], 1, 12, 4) == 4 + 1


# blocks an SM of each tensor-core instance on an H100 (228 KB of shared
# memory an SM): (D, group) -> blocks
H100_TC_BLOCKS = {(64, 8): 5, (64, 16): 5, (128, 8): 3, (128, 16): 2,
                  (256, 8): 1, (256, 16): 1}


def _fake_decode_library(blocks):
    """A stand-in for the built library: its constants and, per
    tensor-core instance, ``blocks[(d, group)]`` blocks an SM."""
    from types import SimpleNamespace

    def held(d, group):
        return blocks[min(dd for dd in (64, 128, 256) if dd >= d),
                      16 if group > 8 else 8]

    return SimpleNamespace(
        decode_attention_launch=SimpleNamespace(),
        decode_attention_max_head_dim=lambda: dec_kernel.MAX_HEAD_DIM,
        decode_attention_max_group_tile=lambda: dec_kernel.MAX_GROUP_TILE,
        decode_attention_tc_head_tile=(
            lambda: dec_kernel.SPLIT_RULES["tensor_core"]["head_tile"]),
        decode_attention_tc_blocks_per_sm=held)


def test_decode_bindings_match_the_c_entry_points():
    """``_bind`` gives each C entry point of ``decode_attention.cu`` one
    ctypes type per parameter of its prototype, in order; the card's
    occupancy (the H100's here) passes its check of the split rule."""
    import ctypes
    import re
    src = dec_kernel.SOURCE.read_text()
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long": ctypes.c_longlong}
    lib = _fake_decode_library(H100_TC_BLOCKS)
    dec_kernel._bind(lib)
    for name in ("decode_attention_launch",
                 "decode_attention_tc_blocks_per_sm"):
        proto = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        params = [" ".join(p.split()) for p in proto.split(",")]
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[-2]]
                for p in params]
        assert list(getattr(lib, name).argtypes) == want, name


@pytest.mark.parametrize("instance", sorted(H100_TC_BLOCKS))
def test_decode_bind_refuses_a_split_rule_the_card_cannot_hold(instance):
    """An instance that holds fewer blocks an SM than the rule gives it
    (a change of stages or tiles in the source), or more where the rule
    takes fewer than the cap, fails the bind instead of mis-sizing the
    grid."""
    d, _ = instance
    rule = dec_kernel.tc_blocks_per_sm(d)
    cap = dec_kernel.SPLIT_RULES["tensor_core"]["blocks_per_sm"]
    wrong = rule - 1 if rule > 1 else 2
    assert min(wrong, cap) != rule
    with pytest.raises(RuntimeError, match=f"D {d}"):
        dec_kernel._bind(_fake_decode_library(
            {**H100_TC_BLOCKS, instance: wrong}))


def test_decode_parts_run_on_the_card_only():
    """``launch_parts`` has no plain version: on the CPU it raises."""
    q = torch.zeros((1, 4, 16))
    k = torch.zeros((1, 1, 8, 16))
    lengths = torch.ones((1,), dtype=torch.int32)
    for parts in (dec_kernel.SPLIT, dec_kernel.COMBINE):
        with pytest.raises(ValueError, match="card"):
            dec_kernel.launch_parts(q, k, k, lengths, parts)


@pytest.mark.parametrize("case,tc", [
    ("bf16", True),
    ("float32", False),
    ("mixed", False),           # bf16 q over a float32 cache
    ("d_not_8", False),         # D 20: rows of 40 bytes
    ("misaligned_k", False),    # k one element off its allocation
    ("strided_rows", False),    # a cache row stride of D + 1
    ("padded_q_rows", True),    # q rows of D + 8: still 16-byte aligned
])
def test_takes_tensor_cores(case, tc):
    """bf16 q, k and v whose rows all start 16-byte aligned take the
    tensor-core split kernel; anything else the SIMT one."""
    bf = torch.bfloat16
    d = 20 if case == "d_not_8" else 64
    q = torch.zeros((2, 8, d), dtype=bf)
    k = torch.zeros((2, 2, 32, d), dtype=bf)
    v = torch.zeros((2, 2, 32, d), dtype=bf)
    if case == "float32":
        q, k, v = q.float(), k.float(), v.float()
    elif case == "mixed":
        k, v = k.float(), v.float()
    elif case == "misaligned_k":
        k = torch.zeros((2 * 2 * 32 * d + 1,), dtype=bf)[1:].view(2, 2, 32, d)
    elif case == "strided_rows":
        k = torch.zeros((2, 2, 32, d + 1), dtype=bf)[..., :d]
    elif case == "padded_q_rows":
        q = torch.zeros((2, 8, d + 8), dtype=bf)[..., :d]
    assert dec_kernel.takes_tensor_cores(q, k, v) is tc
