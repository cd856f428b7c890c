"""The model and step sites the dry run shards, held to the code they
replaced and, on a real 2x2 mesh, to their single-device results.

On plain tensors (the CPU, one card) each site gives what its earlier
expression gave, with ``==``:

* the decode step's cache write (``parallel.local.cache_write_``) writes in
  place, into the same storage (``data_ptr()``), the values of the
  indexed assignment ``cache[bidx, :, slot] = new`` (MLA's ``cache[bidx,
  slot] = new``), the ring buffer's wrap included; a model's decode
  steps keep every cache tensor at its address;
* the MoE aux loss (``moe._token_frac`` under ``token_fraction``) equals
  the ``scatter_add_`` expression it replaced, inside ``moe_apply``;
* the microbatch split keeps the rows of the reshape it replaced;
* the attention's backward op (``flash_attention_backward``) gives
  ``dq``, ``dk`` and ``dv`` equal to autograd of ``flash_attention_ref``.

Then four gloo processes stand a 2x2 ``("data", "model")`` mesh of real
CPU tensors and run the sharded paths: the cache write on every cache
layout ``cache_pspec`` chooses (batch, kv heads, head dim, MLA's latent
dim, the sequence over both axes), the token fractions as a partial
sum, the MoE's grouped dispatch and combine, the cross entropy with
the vocab split (over one axis and over both), the microbatch split of a
sharded batch, and the attention forward and backward ops with the
query heads sharded and the single kv head repeated to the axis, or,
where the axis does not divide the query heads, the batch split over
both axes (``constrain_attention``); each result gathered equals the
single-device one.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.config import get_arch, reduced_config
from repro_torch.kernels.flash_attention.kernel import (
    backward_calls, flash_attention_backward_op)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import moe
from repro_torch.models.lm import build_model
from repro_torch.parallel.local import cache_write_
from repro_torch.train.step import _split_microbatches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


# ------------------------------------------------------------ cache write
@pytest.mark.parametrize("mla", [False, True])
def test_cache_write_in_place_equals_indexed_assignment(mla):
    """Several steps of writes at ``length % cache_len``, past the end of
    the buffer so the slots wrap: same storage, same values as the
    indexed assignment on a copy."""
    rng = np.random.default_rng(0)
    b, s = 3, 5
    shape = (b, s, 6) if mla else (b, 2, s, 4)
    cache = _rand(rng, shape, torch.bfloat16)
    want = cache.clone()
    ptr = cache.data_ptr()
    length = torch.tensor([0, 3, 9], dtype=torch.int32)
    bidx = torch.arange(b)
    for _ in range(7):
        slot = (length % s).long()
        new = _rand(rng, (b, 6) if mla else (b, 2, 4), torch.bfloat16)
        if mla:
            want[bidx, slot] = new
        else:
            want[bidx, :, slot] = new
        cache_write_(cache, new, slot, bidx, seq_dim=1 if mla else 2)
        length = length + 1
    assert cache.data_ptr() == ptr
    assert torch.equal(cache, want)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v3-671b"])
def test_decode_keeps_cache_addresses(arch):
    """A reduced model's decode steps, past danube's ring buffer: every
    cache tensor keeps its ``data_ptr()``."""
    torch.manual_seed(0)
    model = build_model(reduced_config(get_arch(arch)), device="cpu",
                        dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 16, dtype=torch.float32)
    ptrs = [{k: t.data_ptr() for k, t in layer.items()} for layer in cache]
    tok = torch.tensor([1, 2])
    for step in range(20):
        pos = torch.full((2,), step, dtype=torch.int32)
        logits, cache = model.decode_step(tok, cache, pos)
        tok = logits.argmax(-1)
    assert [{k: t.data_ptr() for k, t in layer.items() if k != "length"}
            for layer in cache] == [
        {k: p for k, p in layer.items() if k != "length"} for layer in ptrs]


# ---------------------------------------------------------------- aux loss
def test_aux_loss_equals_scatter_add_expression():
    """``moe_apply``'s aux loss equals the expression it replaced, from
    the same router outputs."""
    cfg = reduced_config(get_arch("moonshot-v1-16b-a3b"))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(1))
    blk = next(b for b in model.layers if "moe" in b.names)
    x = _rand(np.random.default_rng(1), (2, 16, cfg.d_model))
    _, aux = moe.moe_apply(blk.moe, cfg, x)
    m = cfg.moe
    probs, _, top_i = moe.route(blk.moe, cfg, x)
    b, s, k, e = 2, 16, m.top_k, m.n_experts
    token_frac = torch.zeros((e,), dtype=torch.float32)
    token_frac.scatter_add_(0, top_i.reshape(-1), torch.full(
        (b * s * k,), 1.0 / (b * s * k), dtype=torch.float32))
    want = e * torch.sum(token_frac * probs.mean(dim=(0, 1))) \
        * m.router_aux_loss
    assert torch.equal(aux, want)


# -------------------------------------------------------------- microbatch
@pytest.mark.parametrize("n", [1, 2, 4])
def test_microbatch_split_keeps_rows(n):
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 99, (8, 5))),
             "patches": _rand(rng, (8, 3, 4))}
    got = _split_microbatches(batch, n)
    for k, x in batch.items():
        split = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
        for i in range(n):
            assert torch.equal(got[i][k], split[i])
            assert torch.equal(got[i][k], x[i * (8 // n):(i + 1) * (8 // n)])


# -------------------------------------------------------- attention backward
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,causal,window", [
    (4, 1, True, 0), (4, 4, False, 0), (6, 2, True, 3)])
def test_backward_op_equals_autograd(dtype, hq, hkv, causal, window):
    rng = np.random.default_rng(hq * 10 + hkv)
    q = _rand(rng, (2, hq, 9, 16), dtype)
    k = _rand(rng, (2, hkv, 9, 16), dtype)
    v = _rand(rng, (2, hkv, 9, 16), dtype)
    grad = _rand(rng, (2, hq, 9, 16), dtype)
    before = backward_calls["flash_attention_backward"]
    got = flash_attention_backward_op(grad, q, k, v, causal, window,
                                      16 ** -0.5)
    assert backward_calls["flash_attention_backward"] == before + 1
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = flash_attention_ref(qq, kk, vv, causal=causal, window=window,
                              scale=16 ** -0.5)
    want = torch.autograd.grad(out, (qq, kk, vv), grad)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------ a real 2x2 mesh
_WORKER = textwrap.dedent("""
    import functools, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import moe
    from repro_torch.parallel.constraints import (
        constrain_attention, default_rules, set_activation_rules)
    from repro_torch.parallel.local import (cache_write_, grouped,
                                            token_fraction)
    from repro_torch.parallel.sharding import (MeshAxes, P, placements,
                                               register_op_shardings)
    from repro_torch.train.step import _split_microbatches

    rank, init = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    R = [Replicate(), Replicate()]
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))

    def put(t, spec):
        return distribute_tensor(t, mesh, placements(P(*spec), mesh))

    # the cache write on every layout cache_pspec chooses
    for shape, seq_dim, spec in [
            ((4, 2, 8, 4), 2, ("data", "model", None, None)),
            ((4, 2, 8, 4), 2, ("data", None, None, "model")),
            ((2, 2, 8, 4), 2, (None, None, ("data", "model"), None)),
            ((4, 8, 6), 1, ("data", None, "model")),
            ((2, 8, 6), 1, (None, ("data", "model"), None))]:
        for _ in range(3):
            cache = rand(*shape)
            b = shape[0]
            new = rand(*(shape[:seq_dim] + shape[seq_dim + 1:]))
            slot = torch.from_numpy(rng.integers(0, 8, (b,)))
            want = cache.clone()
            bidx = torch.arange(b)
            cache_write_(want, new, slot, bidx, seq_dim)
            d = put(cache, spec)
            local = d.to_local()
            ptr = local.data_ptr()
            cache_write_(d, distribute_tensor(new, mesh, R),
                         distribute_tensor(slot, mesh, R), bidx, seq_dim)
            assert d.to_local().data_ptr() == ptr, spec
            assert torch.equal(d.full_tensor(), want), spec

    # the token fractions, a partial sum over the batch axes
    top_i = torch.from_numpy(rng.integers(0, 5, (4, 3, 2)))
    count = functools.partial(moe._token_frac, e=5, total=24)
    got = token_fraction(count, put(top_i, ("data", None, None)))
    assert got.placements == (Partial(), Replicate())
    torch.testing.assert_close(got.full_tensor(), count(top_i),
                               rtol=1e-6, atol=0)

    # the grouped dispatch and combine, one group per batch row
    x = rand(4, 6, 8)
    ti = torch.from_numpy(rng.integers(0, 4, (4, 6, 2)))
    tp = torch.softmax(rand(4, 6, 2), -1)
    disp = functools.partial(moe.dispatch, cap=3, e=4)
    buf, state = disp(x, ti)
    dbuf, dstate = grouped(disp, 5, put(x, ("data", None, None)),
                           put(ti, ("data", None, None)))
    assert torch.equal(dbuf.full_tensor(), buf)
    for a, b in zip(dstate, state):
        assert torch.equal(a.full_tensor(), b)
    out = rand(4, 4, 3, 8)
    y = grouped(moe.combine, 1, put(out, ("data", "model", None, None)),
                put(tp, ("data", None, None)), dstate)
    assert torch.equal(y.full_tensor(), moe.combine(out, tp, state))

    # the cross entropy on logits split over the batch and the vocab: the
    # loss and its gradient equal the single-device ones, and the
    # gradient keeps the logits' layout
    from repro_torch.models.lm import _xent
    logits, labels = rand(4, 3, 10), torch.from_numpy(
        rng.integers(0, 10, (4, 3)))
    want_l = logits.clone().requires_grad_(True)
    want = _xent(want_l, labels)
    want.backward()
    for spec in (("data", None, "model"), (None, None, ("data", "model")),
                 ("data", None, None)):
        d = put(logits, spec).requires_grad_(True)
        got = _xent(d, put(labels, spec[:2]))
        got.backward()
        torch.testing.assert_close(got.full_tensor(), want, rtol=1e-6,
                                   atol=0)
        assert d.grad.placements == d.placements, spec
        torch.testing.assert_close(d.grad.full_tensor(), want_l.grad,
                                   rtol=1e-5, atol=1e-7)

    set_activation_rules(default_rules(MeshAxes(mesh)))
    register_op_shardings()

    # the microbatch split of a sharded batch keeps the rows
    tokens = torch.from_numpy(rng.integers(0, 99, (8, 5)))
    for n in (2, 4):
        mbs = _split_microbatches({"tokens": put(tokens, ("data", None))}, n)
        for i, mb in enumerate(mbs):
            m = 8 // n
            assert mb["tokens"].placements[0] == Shard(0)
            assert torch.equal(mb["tokens"].full_tensor(),
                               tokens[i * m:(i + 1) * m])

    # attention with the query heads sharded and the kv head repeated
    # (4 heads over the model axis of 2), or with the batch split over
    # both axes (3 heads do not divide it)
    heads = ("act_batch", "act_model", None, None)
    for hq, want_kv, want_pl in ((4, 2, (Shard(0), Shard(1))),
                                 (3, 1, (Shard(0), Shard(0)))):
        q, k, v, g = (rand(4, hq, 5, 8), rand(4, 1, 5, 8), rand(4, 1, 5, 8),
                      rand(4, hq, 5, 8))
        leaves = [distribute_tensor(t, mesh, R).requires_grad_(True)
                  for t in (q, k, v)]
        qd, kd, vd = constrain_attention(*leaves, heads)
        assert kd.shape == (4, want_kv, 5, 8)
        out = flash_attention_op(qd, kd, vd, True, 0, None)
        assert out.placements == want_pl, out.placements
        out.backward(distribute_tensor(g, mesh, out.placements))
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        want = flash_attention_ref(ql, kl, vl, causal=True)
        want.backward(g)
        torch.testing.assert_close(out.full_tensor(), want, rtol=1e-6,
                                   atol=1e-6)
        for d, t in zip(leaves, (ql, kl, vl)):
            torch.testing.assert_close(d.grad.full_tensor(), t.grad,
                                       rtol=1e-5, atol=1e-6)
    print("ok")
    dist.destroy_process_group()
""")


def test_sharded_sites_on_a_real_mesh(tmp_path):
    init = f"file://{tmp_path / 'store'}"
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), init],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        assert out.strip().endswith("ok")
