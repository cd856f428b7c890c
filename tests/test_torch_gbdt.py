"""The port's GBDT scoring (``repro_torch.kernels.gbdt_infer``) against the
reference package's.

On the CPU the wrappers run their plain torch versions, which carry the
kernels' float32 summation order; they are held bit-identical to
``ObliviousGBDT.decision_function`` and the reference's numpy grid
scorer, and within the reference kernel tests' ``atol=2e-6`` (on
probabilities, ``tests/test_kernels.py``) of the Pallas kernel run in
interpret mode. The kernels themselves are tested on a card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.core.ml.gbdt import train_gbdt as ref_train_gbdt
from repro.kernels.gbdt_infer.ops import GridGBDTScorer as RefGridScorer
from repro.kernels.gbdt_infer.ops import gbdt_predict_proba as ref_predict
from repro.kernels.gbdt_infer.ops import pack_gbdt as ref_pack
from repro_torch.configs.carat_defaults import SPACES
from repro_torch.core.ml.gbdt import (ObliviousGBDT, default_models,
                                      gbdt_from_reference, load_gbdt,
                                      save_gbdt)
from repro_torch.device import resolve_device
from repro_torch.kernels.gbdt_infer import kernel
from repro_torch.kernels.gbdt_infer.kernel import (gbdt_grid_logits,
                                                   gbdt_logits,
                                                   grid_geometry,
                                                   logits_geometry,
                                                   pairwise_plan)
from repro_torch.kernels.gbdt_infer.ops import (GBDTScorer, GridGBDTScorer,
                                                gbdt_predict_proba,
                                                pack_gbdt)
from repro_torch.kernels.gbdt_infer.ref import pairwise_sum

THETA = SPACES.theta_features()


def _port(m) -> ObliviousGBDT:
    return gbdt_from_reference(m.feat, m.thr, m.leaf, m.base, m.n_features)


def _rows(seed, n, f, scale=1.0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return (rng.normal(size=(n, f)) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def trained_gbdt():
    """The reference kernel tests' model (80 trees of depth 5, 22 features)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 22)).astype(np.float32)
    y = ((X[:, 0] * X[:, 3] + X[:, 7] > 0)).astype(np.int32)
    return ref_train_gbdt(X, y, n_trees=80, depth=5)


# ------------------------------------------------------------ summation order
@pytest.mark.parametrize("n", [1, 5, 7, 8, 9, 64, 127, 128, 129, 184, 223,
                               400, 1000])
def test_pairwise_sum_matches_numpy_float32_sum(n):
    x = _rows(n, 200, n, scale=3.0)
    got = pairwise_sum(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, x.sum(axis=1))


def _pairwise_levels(n):
    """Splits above 128 on the deepest path of NumPy's pairwise sum."""
    if n <= 128:
        return 0
    n2 = n // 2 - (n // 2) % 8
    return 1 + max(_pairwise_levels(n2), _pairwise_levels(n - n2))


def test_pairwise_levels_cover_production_tree_counts():
    """Every tree count the kernels took before the plan (at most five
    splits above 128, i.e. up to 4096 trees) fits both kernels' shared
    memory at depths 1 to 16. Far more trees raise in ``gbdt_logits``
    (a tile's partials outgrow shared memory) before any launch; the grid
    scorer's fold keeps a stack of block sums and takes them."""
    assert _pairwise_levels(128) == 0 and _pairwise_levels(129) == 1
    assert max(t for t in range(1, 5000) if _pairwise_levels(t) <= 5) == 4096
    for t in range(1, 4097):
        for depth in (1, 5, 16):
            assert logits_geometry(63, 22, t, depth).stage_x
            assert grid_geometry(4096, 63, t, depth).smem \
                <= kernel.MAX_SMEM_BYTES
    with pytest.raises(ValueError):
        logits_geometry(63, 22, 200_000, 1)
    assert not grid_geometry(4096, 63, 200_000, 1).resident


# -------------------------------------------------- cross-product gbdt_logits
@pytest.mark.parametrize("which", ["trained", "read", "write"])
def test_plain_logits_bit_identical_to_decision_function(
        which, trained_gbdt, tiny_models):
    ref = trained_gbdt if which == "trained" else tiny_models[which]
    model = _port(ref)
    packed = pack_gbdt(model, device="cpu")
    X = _rows(11, 300, model.n_features)
    got = gbdt_logits(torch.from_numpy(X), packed.feat, packed.thr,
                      packed.leaf, packed.base).numpy()
    assert np.array_equal(got, model.decision_function(X))
    assert np.array_equal(got, ref.decision_function(X))
    assert np.array_equal(GBDTScorer(model, device="cpu").predict_proba(X),
                          ref.predict_proba(X))


@pytest.mark.parametrize("n", [1, 63, 200])
def test_plain_logits_match_pallas_kernel_and_jnp_oracle(trained_gbdt, n):
    X = _rows(n, n, 22)
    got = gbdt_predict_proba(pack_gbdt(_port(trained_gbdt), device="cpu"), X)
    ref_packed = ref_pack(trained_gbdt)
    for backend in ("pallas", "jnp"):
        want = ref_predict(ref_packed, X, backend=backend, interpret=True)
        np.testing.assert_allclose(got, want, atol=2e-6, err_msg=backend)


# ------------------------------------------------------- grid scorer (fleet)
@pytest.mark.parametrize("op", ["read", "write"])
@pytest.mark.parametrize("seed,n", [(0, 1), (1, 8), (2, 37)])
def test_grid_scorer_bit_identical_to_reference_numpy(tiny_models, op, seed,
                                                      n):
    ref = tiny_models[op]
    H = _rows(seed, n, 20, scale=0.5)
    want = RefGridScorer(ref, THETA, backend="numpy")(H)
    got = GridGBDTScorer(_port(ref), THETA, device="cpu")(H)
    assert got.dtype == want.dtype and got.shape == (n, len(THETA))
    assert np.array_equal(got, want)
    # and to the per-client cross product (tests/test_fleet.py:54)
    X = np.concatenate([np.broadcast_to(H[0], (len(THETA), 20)), THETA],
                       axis=1).astype(np.float32)
    assert np.array_equal(got[0], ref.predict_proba(X))


def test_grid_scorer_rejects_bad_rows(tiny_models):
    sc = GridGBDTScorer(_port(tiny_models["read"]), THETA, device="cpu")
    with pytest.raises(ValueError):
        sc(np.zeros((3, 19), dtype=np.float32))
    assert sc(np.zeros(20, dtype=np.float32)).shape == (1, len(THETA))


# ----------------------------------------------------------------- weights
def test_gbdt_from_reference_and_npz_round_trip(tiny_models, tmp_path):
    ref = tiny_models["write"]
    model = _port(ref)
    assert model.feat.dtype == np.int32 and model.thr.dtype == np.float32
    path = str(tmp_path / "m.npz")
    save_gbdt(model, path)
    back = load_gbdt(path)
    for f in ("feat", "thr", "leaf"):
        assert np.array_equal(getattr(back, f), getattr(ref, f))
    assert back.base == ref.base and back.n_features == ref.n_features


def test_committed_models_are_the_reference_production_pair(tiny_models):
    """The assets are the reference's seed-0 ``get_default_models()``."""
    for mine, ref in zip(default_models(), (tiny_models["read"],
                                            tiny_models["write"])):
        for f in ("feat", "thr", "leaf"):
            assert np.array_equal(getattr(mine, f), getattr(ref, f))
        assert mine.base == ref.base


# ----------------------------------------------------------- no fallback
def test_cuda_request_without_cuda_raises(tiny_models, monkeypatch):
    """Asking for CUDA where there is none raises; nothing drops to the
    CPU quietly (the default device is CUDA)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _port(tiny_models["read"])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        GridGBDTScorer(model, THETA)
    with pytest.raises(RuntimeError, match="CUDA"):
        GBDTScorer(model, device="cuda")


def test_wrappers_reject_a_device_they_have_no_kernel_for(tiny_models):
    """A tensor that is neither on the CPU nor on a CUDA device, or model
    operands on another device than the rows, raise before any launch."""
    model = _port(tiny_models["read"])
    packed = pack_gbdt(model, device="cpu")
    sc = GridGBDTScorer(model, THETA, device="cpu")
    meta = {k: getattr(packed, k).to("meta") for k in ("feat", "thr", "leaf")}
    before = dict(kernel.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        gbdt_logits(torch.zeros((4, 22), device="meta"), meta["feat"],
                    meta["thr"], meta["leaf"], packed.base)
    with pytest.raises(ValueError, match="expected cpu"):
        gbdt_logits(torch.zeros((4, 22)), meta["feat"], meta["thr"],
                    meta["leaf"], packed.base)
    grid_ops = [t.to("meta") for t in (sc.cfeat, sc.thr, sc.idx_theta,
                                       sc.leaf_flat)]
    with pytest.raises(ValueError, match="unsupported device"):
        gbdt_grid_logits(torch.zeros((4, 20), device="meta"), *grid_ops)
    assert kernel.launches == before


# ------------------------------------------------- the kernels' pairwise plan
def _combine8(r):
    return ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))


def _chain_sum(plan, a):
    """``gbdt_logits``'s arithmetic on the (rows, n) float32 terms ``a``:
    each chain accumulated alone into its slots; then each leaf block's 8
    partials combined and its tail added, the block sums merged on a
    stack as ``merges`` says, and NumPy's identity 0.0 added (as the
    kernel writes the result)."""
    f32 = np.float32
    slots = np.zeros((plan.n_slots, a.shape[0]), dtype=f32)
    for first, count, stride, mode, slot in plan.chains:
        terms = [a[:, first + i * stride] for i in range(count)]
        if mode == kernel.CHAIN_TERMS:
            slots[slot:slot + count] = np.stack(terms)
            continue
        if mode == kernel.CHAIN_FROM_ZERO:
            acc = np.zeros(a.shape[0], dtype=f32)
        else:
            acc, terms = terms[0], terms[1:]
        for t in terms:
            acc = acc + t
        slots[slot] = acc
    stack = []
    for lo, m, slot, merges in plan.blocks:
        res = slots[slot]
        if m >= 8:
            res = _combine8(slots[slot:slot + 8])
            for i in range(m % 8):
                res = res + slots[slot + 8 + i]
        stack.append(res)
        for _ in range(merges):
            top = stack.pop()
            stack[-1] = stack[-1] + top
    return f32(0.0) + stack[0]


def _block_sum(plan, a):
    """``gbdt_grid_logits``'s arithmetic: each leaf block summed by one
    thread with NumPy's 8 accumulators, pushed on a stack whose top two
    sums are added ``merges`` times after the block, then NumPy's
    identity 0.0 added."""
    f32 = np.float32
    stack = []
    for lo, m, _, merges in plan.blocks:
        b = a[:, lo:lo + m]
        if m < 8:
            res = np.zeros(a.shape[0], dtype=f32)
            for i in range(m):
                res = res + b[:, i]
        else:
            full = m - m % 8
            r = [b[:, j] for j in range(8)]
            for i in range(8, full, 8):
                r = [r[j] + b[:, i + j] for j in range(8)]
            res = _combine8(r)
            for i in range(full, m):
                res = res + b[:, i]
        stack.append(res)
        assert len(stack) <= plan.stack_depth
        for _ in range(merges):
            top = stack.pop()
            stack[-1] = stack[-1] + top
    assert len(stack) == 1
    return f32(0.0) + stack[0]


def _terms(seed, n):
    """Seeded float32 terms of mixed signs and magnitudes, with rows of
    -0.0, rows of +0.0 and rows sprinkled with both."""
    rng = np.random.Generator(np.random.PCG64(seed))
    a = (rng.normal(size=(8, n))
         * np.exp(3.0 * rng.normal(size=(8, n)))).astype(np.float32)
    a[1] = -0.0
    a[2] = 0.0
    a[3, ::2] = -0.0
    a[4, ::3] = 0.0
    a[5, 1::3] = -0.0
    return a


@pytest.mark.parametrize("lo", range(1, 2049, 128))
def test_pairwise_plan_reproduces_numpy_sum_bit_for_bit(lo):
    """Both kernels' orders, as the plan spells them, give NumPy's float32
    ``sum(axis=1)`` to the bit (signs of zero included) for every tree
    count from 1 to 2048."""
    for n in range(lo, lo + 128):
        a = _terms(n, n)
        want = a.sum(axis=1).view(np.uint32)
        plan = pairwise_plan(n)
        assert np.array_equal(_chain_sum(plan, a).view(np.uint32), want), n
        assert np.array_equal(_block_sum(plan, a).view(np.uint32), want), n


@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 127, 128, 129, 184, 223, 400,
                               1000, 2048, 4096])
def test_pairwise_plan_structure(n):
    """Leaf blocks tile the terms left to right, at most 128 each and
    starting at multiples of 8; every term is in exactly one chain, no
    chain longer than 16; the slots and merges agree with the chains and
    the recursion."""
    plan = pairwise_plan(n)
    lo, length, slot, merges = plan.blocks.T
    assert lo[0] == 0 and np.array_equal(lo[1:], (lo + length)[:-1])
    assert (lo + length)[-1] == n and length.max() <= 128
    assert (lo % 8 == 0).all() and ((length >= 8).all() or n < 8)
    assert merges.sum() == len(lo) - 1 and merges[-1] == plan.stack_depth - 1
    assert plan.stack_depth <= (1 if n < 8 else 8)
    seen = np.concatenate([first + stride * np.arange(count)
                           for first, count, stride, _, _ in plan.chains])
    assert np.array_equal(np.sort(seen), np.arange(n))
    assert plan.chains[:, 1].max() <= 16
    per_block = np.where(length < 8, 1, 8 + length % 8)
    assert np.array_equal(slot, np.concatenate([[0], np.cumsum(per_block)])
                          [:-1])
    assert plan.n_slots == per_block.sum()
    table, off = plan.table()
    assert table.dtype == np.int32
    assert sum(rows * width for (_, rows), width in
               zip(off.values(), (4, 5))) == table.size


def test_pairwise_plan_of_the_production_models():
    """184 trees (read) are 2 blocks of 8 chains of 11-12 trees and no
    tail; 223 (write) are 16 chains of 13-14 trees and a tail of 7."""
    read, write = pairwise_plan(184), pairwise_plan(223)
    assert read.blocks.tolist() == [[0, 88, 0, 0], [88, 96, 8, 1]]
    assert read.chains.shape[0] == 16 and read.n_slots == 16
    assert sorted(set(read.chains[:, 1])) == [11, 12]
    assert write.blocks.tolist() == [[0, 104, 0, 0], [104, 119, 8, 1]]
    assert write.chains.shape[0] == 17 and write.n_slots == 23
    assert write.chains[-1].tolist() == [216, 7, 1, kernel.CHAIN_TERMS, 16]
    assert read.stack_depth == write.stack_depth == 2
    assert pairwise_plan(4096).stack_depth == 6
    assert pairwise_plan(5).chains.tolist() == [
        [0, 5, 1, kernel.CHAIN_FROM_ZERO, 0]]
    with pytest.raises(ValueError):
        pairwise_plan(0)


# ------------------------------------------------------ the launch geometries
def test_geometries_depend_on_shapes_only():
    import inspect
    assert list(inspect.signature(logits_geometry).parameters) == [
        "n_rows", "n_features", "n_trees", "depth", "sms"]
    assert list(inspect.signature(grid_geometry).parameters) == [
        "n_clients", "n_cand", "n_trees", "depth", "sms"]
    assert len({logits_geometry(63, 22, 184, 5, 132) for _ in range(3)}) == 1
    assert len({grid_geometry(4096, 63, 223, 5, 132)
                for _ in range(3)}) == 1


@pytest.mark.parametrize("n,trees,blocks,threads", [
    (1, 184, 1, 512), (63, 184, 1, 512), (63, 223, 1, 544),
    (64, 184, 1, 512), (65, 184, 2, 512), (258_048, 184, 528, 512),
    (258_048, 223, 396, 544), (4096, 1000, 64, 1024), (4096, 7, 64, 32)])
def test_logits_geometry(n, trees, blocks, threads):
    """A warp per chain (at most 32); 64-row tiles, a block for each up to
    what the SMs hold at once (4 blocks of 512 threads on each of 132
    SMs); the 22-feature row tile and the model (8 bytes a split) staged
    beside the chains' partials."""
    geo = logits_geometry(n, 22, trees, 5, 132)
    assert (geo.blocks, geo.threads) == (blocks, threads)
    slots = pairwise_plan(trees).n_slots
    model = -(-2 * trees * 5 // 4) * 4 + trees * 32
    assert geo.stage_x and geo.stage_model
    assert geo.smem == 4 * (64 * slots + 1432 + model)


def test_logits_geometry_reads_what_does_not_fit_through_l1():
    """Rows too wide to stage beside the partials are read from device
    memory, and so is a model too large to stage; the partials alone
    decide whether the call fits."""
    geo = logits_geometry(63, 5000, 184, 5)
    assert not geo.stage_x and geo.stage_model
    assert logits_geometry(63, 878, 184, 1).stage_x
    assert not logits_geometry(63, 879, 184, 1).stage_x
    deep = logits_geometry(63, 22, 184, 12)
    assert deep.stage_x and not deep.stage_model
    assert deep.smem == 4 * (64 * 16 + 1432)
    assert logits_geometry(4096, 22, 1000, 5).stage_model
    assert not logits_geometry(4096, 22, 1400, 5).stage_model


@pytest.mark.parametrize("n,trees,blocks,units,resident", [
    (1, 184, 1, 1, True), (300, 184, 19, 19, True),
    (4096, 184, 256, 256, True), (4096, 223, 132, 256, True),
    (4096, 400, 132, 256, True), (4096, 1000, 256, 256, False),
    (100_000, 184, 264, 6250, True)])
def test_grid_geometry(n, trees, blocks, units, resident):
    """The 63-candidate grid: 16 clients a pass (4 per thread, 64
    candidate lanes); the path's models stay resident (the read model's
    block fits twice on an SM, the write model's once), 1000 trees are
    staged a leaf block at a time."""
    geo = grid_geometry(n, 63, trees, 5, 132)
    assert (geo.cand_width, geo.clients_per_pass) == (64, 16)
    assert (geo.blocks, geo.units, geo.resident) == (blocks, units, resident)
    assert geo.stage_leaves and geo.window % 8 == 0
    assert geo.window == (-(-trees // 8) * 8 if resident else 128)


def test_grid_geometry_chunks_and_deep_trees():
    """Candidates past 256 go in chunks of 256 (one client a pass, never
    resident); leaves too large to stage are gathered through L1."""
    wide = grid_geometry(4096, 300, 184, 5, 132)
    assert (wide.cand_width, wide.clients_per_pass) == (256, 4)
    assert wide.units == 2048 and not wide.resident
    assert grid_geometry(10, 20, 184, 5, 132).cand_width == 32
    deep = grid_geometry(4096, 63, 184, 16, 132)
    assert not deep.resident and not deep.stage_leaves
    assert grid_geometry(4096, 63, 184, 9, 132).stage_leaves is False
    assert grid_geometry(4096, 63, 184, 8, 132).stage_leaves


def test_bindings_match_the_c_entry_points():
    """``_bind`` gives each C entry point of ``gbdt_infer.cu`` one ctypes
    type per parameter of its prototype, in order (a pointer as
    ``c_void_p``, an int as ``c_int``, a float as ``c_float``); the card
    is needed only to run them."""
    import ctypes
    import re
    from types import SimpleNamespace
    src = kernel.SOURCE.read_text()
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    consts = {"gbdt_tile_rows": kernel.TILE_ROWS,
              "gbdt_grid_threads": kernel.GRID_THREADS,
              "gbdt_grid_clients": kernel.GRID_CLIENTS}
    lib = SimpleNamespace(**{name: SimpleNamespace() for name in
                             ("gbdt_logits_launch",
                              "gbdt_grid_logits_launch")})
    for name, value in consts.items():
        fn = (lambda v: lambda: v)(value)
        setattr(lib, name, fn)
    kernel._bind(lib)
    for name in ("gbdt_logits_launch", "gbdt_grid_logits_launch"):
        proto = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        params = [" ".join(p.split()) for p in proto.split(",")]
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[-2]]
                for p in params]
        assert getattr(lib, name).argtypes == want, name
        assert getattr(lib, name).restype == ctypes.c_int
