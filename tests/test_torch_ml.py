"""The port's model layer, twinned with ``tests/test_ml.py`` and held to
the reference's.

The twins run the reference's eight cases against the port (the nets on
the CPU). Beside them:

* each net's forward on the reference's initial weights, carried across
  by ``net_params_from_reference``, equals ``arch.apply`` at ``atol=1e-5``
  in float32;
* ``train_net`` from those carried weights (each side's ``init`` patched
  to return them) follows the reference's trajectory: parameters at
  ``atol=1e-4`` and ``predict_proba`` at ``atol=1e-5`` after 3 epochs;
* ``train_svm``, ``collect_training_data``, ``collect_replayed_data``
  and ``train_all_models``' SVM and GBDT entries equal the reference's
  with ``==``; ``get_default_models`` regenerates the committed
  production pair byte for byte.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import repro.core.ml.dataset as ref_dataset
import repro.core.ml.nets as ref_nets
import repro.core.ml.svm as ref_svm
import repro.core.ml.train as ref_train
import repro.storage as ref_storage
from repro_torch.core.ml import dataset, gbdt, train
from repro_torch.core.ml.gbdt import default_models, train_gbdt
from repro_torch.core.ml.nets import (FCNN, TCN, VanillaRNN, NetModel,
                                      net_params_from_reference, train_net)
from repro_torch.core.ml.svm import train_svm
from repro_torch.core.ml.train import load_gbdt, save_gbdt

CPU = "cpu"
ARCHS = [(FCNN, ref_nets.FCNN), (VanillaRNN, ref_nets.VanillaRNN),
         (TCN, ref_nets.TCN)]
ARCH_IDS = ["FCNN", "VanillaRNN", "TCN"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The nets' products are small: on one thread they train as fast as
    on many, and a test worker beside others does not oversubscribe the
    cores (results stay within every tolerance here)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny_training_data():
    """The port's sweep at the reference conftest's size."""
    return dataset.collect_training_data(reps=6, duration_s=45.0, seed=0)


@pytest.fixture(scope="module")
def tiny_models():
    """The port's production GBDT pair: the committed seed-0 assets."""
    m_r, m_w = default_models()
    return {"read": m_r, "write": m_w}


@pytest.fixture
def jax_f32():
    """The reference's nets in JAX's default float32, whatever an earlier
    test in this process left the x64 flag at (``soa-jax`` turns it on)."""
    import jax
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield jax
    jax.config.update("jax_enable_x64", before)


def _xor_data(n=4000, seed=0, dim=22):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, dim)).astype(np.float32)
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.int32)
    return X, y


def _linear_data(n=4000, seed=0, dim=22):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, dim)).astype(np.float32)
    y = (X[:, 2] - 0.5 * X[:, 5] > 0).astype(np.int32)
    return X, y


def _radial_data(n=3000, seed=0, dim=22):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, dim)).astype(np.float32)
    r = X[:, 0] ** 2 + X[:, 1] ** 2
    y = (r > np.median(r)).astype(np.int32)
    return X, y


# ------------------------------------------------- twins of tests/test_ml.py
def test_gbdt_learns_nonlinear():
    X, y = _xor_data()
    m = train_gbdt(X[:3000], y[:3000], n_trees=150, depth=4)
    acc = (m.predict(X[3000:]) == y[3000:]).mean()
    assert acc > 0.9


def test_svm_learns_linear_but_not_xor():
    Xl, yl = _linear_data()
    svm_ = train_svm(Xl[:3000], yl[:3000])
    assert (svm_.predict(Xl[3000:]) == yl[3000:]).mean() > 0.9
    Xx, yx = _xor_data()
    svm2 = train_svm(Xx[:3000], yx[:3000])
    # the paper's point: SVM underfits the nonlinear problem
    assert (svm2.predict(Xx[3000:]) == yx[3000:]).mean() < 0.65


@pytest.mark.parametrize("arch_cls", [FCNN, VanillaRNN, TCN], ids=ARCH_IDS)
def test_nets_learn(arch_cls):
    """Nets must clearly beat chance on a nonlinear (radial) task — the
    paper finds they still lag GBDT, which test_gbdt_learns_nonlinear holds
    to >0.9 on the harder XOR task."""
    X, y = _radial_data()
    m = train_net(arch_cls(X.shape[1]), X[:2400], y[:2400],
                  X[2400:], y[2400:], epochs=80, device=CPU)
    acc = (m.predict(X[2400:]) == y[2400:]).mean()
    assert acc > 0.75


def test_gbdt_save_load_roundtrip():
    X, y = _xor_data(n=1000)
    m = train_gbdt(X, y, n_trees=30, depth=4)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "m.npz")
        save_gbdt(m, p)
        m2 = load_gbdt(p)
    np.testing.assert_allclose(m.predict_proba(X), m2.predict_proba(X))


def test_gbdt_probability_calibration(tiny_training_data, tiny_models):
    """P>0.8 predictions should actually be mostly positive (the tuner's
    tau-filter depends on this)."""
    (Xtr, ytr, Xva, yva), _ = tiny_training_data.split()
    m = tiny_models["read"]
    p = m.predict_proba(Xva)
    sel = p > 0.8
    if sel.sum() >= 10:
        assert yva[sel].mean() > 0.7


def test_training_data_shapes(tiny_training_data):
    d = tiny_training_data
    assert d.X_read.shape[1] == 22        # 20 features + 2 theta
    assert d.X_write.shape[1] == 22
    assert set(np.unique(d.y_read)) <= {0, 1}
    assert len(d.X_read) > 100


# ----------------------------------------------- the nets against the JAX ones
@pytest.mark.parametrize("port_cls,ref_cls", ARCHS, ids=ARCH_IDS)
def test_forward_matches_reference(jax_f32, port_cls, ref_cls):
    import jax.numpy as jnp
    ref_arch = ref_cls(22)
    ref_params = ref_arch.init(jax_f32.random.PRNGKey(3))
    X = np.random.default_rng(0).normal(size=(257, 22)).astype(np.float32)
    want = np.asarray(ref_arch.apply(ref_params, jnp.asarray(X)))
    arch = port_cls(22)
    arch.load_state_dict(net_params_from_reference(
        arch, jax_f32.tree_util.tree_map(np.asarray, ref_params)))
    with torch.no_grad():
        got = arch(torch.from_numpy(X)).numpy()
    assert got.shape == want.shape == (257,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_reference_layout_covers_every_parameter():
    for port_cls, ref_cls in ARCHS:
        arch = port_cls(22)
        state = arch.init(torch.Generator().manual_seed(0))
        assert set(state) == set(arch.state_dict())
        for k, v in state.items():
            assert v.shape == arch.state_dict()[k].shape, k
    with pytest.raises(TypeError):
        net_params_from_reference(torch.nn.Linear(2, 2), {})


@pytest.mark.parametrize("port_cls,ref_cls", ARCHS, ids=ARCH_IDS)
def test_train_net_follows_reference_trajectory(jax_f32, monkeypatch,
                                                port_cls, ref_cls):
    """3 epochs of 4 batches (the last one short) from the same carried
    weights: the hand-written Adam, the BCE and the PCG64 batch order
    agree with the reference's."""
    X, y = _radial_data(n=1700, seed=4)
    ref_arch = ref_cls(22)
    init = ref_arch.init(jax_f32.random.PRNGKey(1))
    init_np = jax_f32.tree_util.tree_map(np.asarray, init)
    monkeypatch.setattr(ref_arch, "init", lambda rng: init)
    ref_model = ref_nets.train_net(ref_arch, X, y, epochs=3, seed=7)

    arch = port_cls(22)
    monkeypatch.setattr(arch, "init", lambda gen: net_params_from_reference(
        arch, init_np))
    model = train_net(arch, X, y, epochs=3, seed=7, device=CPU)
    assert model.steps == 12

    want = net_params_from_reference(port_cls(22), jax_f32.tree_util.tree_map(
        np.asarray, ref_model.params))
    got = model.module.state_dict()
    moved = 0.0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
        moved = max(moved, float((want[k] - net_params_from_reference(
            port_cls(22), init_np)[k]).abs().max()))
    assert moved > 1e-3            # the weights did move
    np.testing.assert_allclose(model.predict_proba(X[:300]),
                               ref_model.predict_proba(X[:300]),
                               rtol=0, atol=1e-5)


def test_net_model_defaults_to_cuda_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default holds there")
    X, y = _radial_data(n=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_net(FCNN(22), X, y, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        NetModel(FCNN(22), np.zeros(22, np.float32), np.ones(22, np.float32))


def test_early_stop_keeps_best_validation_weights():
    X, y = _radial_data(n=1200, seed=2)
    m = train_net(FCNN(22), X[:900], y[:900], X[900:], y[900:], epochs=40,
                  patience=3, seed=1, device=CPU)
    assert 0 < m.steps < 40 * 2         # it stopped early
    err = float(np.mean(m.predict(X[900:]) != y[900:]))
    # no other epoch's weights scored better on the validation split
    again = train_net(FCNN(22), X[:900], y[:900], epochs=m.steps // 2,
                      seed=1, device=CPU)
    assert err <= float(np.mean(again.predict(X[900:]) != y[900:])) + 1e-4


# ------------------------------------------------------ SVM and the sweep
@pytest.mark.parametrize("data", [_linear_data, _xor_data])
def test_train_svm_equals_reference(data):
    X, y = data()
    got = train_svm(X[:3000], y[:3000], seed=3)
    want = ref_svm.train_svm(X[:3000], y[:3000], seed=3)
    assert np.array_equal(got.w, want.w) and got.b == want.b
    assert (got.platt_a, got.platt_b) == (want.platt_a, want.platt_b)
    assert np.array_equal(got.predict_proba(X), want.predict_proba(X))


def _assert_same_data(got, want):
    for field in ("X_read", "y_read", "X_write", "y_write"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_collect_training_data_equals_reference(tiny_training_data):
    want = ref_dataset.collect_training_data(reps=6, duration_s=45.0, seed=0)
    _assert_same_data(tiny_training_data, want)
    assert len(want.X_read) > 1000 and len(want.X_write) > 1000


def test_collect_phased_data_equals_reference():
    kw = dict(reps=3, duration_s=12.0, seed=2, phased_frac=0.5)
    _assert_same_data(dataset.collect_training_data(**kw),
                      ref_dataset.collect_training_data(**kw))


def test_collect_replayed_data_equals_reference():
    import repro_torch.storage as port_storage
    name = port_storage.bundled_traces()[0]
    got = dataset.collect_replayed_data(port_storage.compile_trace(
        port_storage.load_bundled_trace(name)), reps=2, seed=1)
    want = ref_dataset.collect_replayed_data(ref_storage.compile_trace(
        ref_storage.load_bundled_trace(name)), reps=2, seed=1)
    _assert_same_data(got, want)
    assert len(want.X_read) + len(want.X_write) > 0


def test_split_equals_reference(tiny_training_data):
    want = ref_dataset.TrainingData(**vars(tiny_training_data)).split(
        frac=0.7, seed=5)
    got = tiny_training_data.split(frac=0.7, seed=5)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)


# -------------------------------------------------- training orchestration
def test_default_cache_is_the_ports_own():
    assert train.DEFAULT_CACHE != ref_train.DEFAULT_CACHE
    assert os.path.basename(train.DEFAULT_CACHE) == "torch"
    assert train.save_gbdt is gbdt.save_gbdt
    assert train.load_gbdt is gbdt.load_gbdt


def test_get_default_models_regenerates_committed_assets(tmp_path):
    """The full §IV-B protocol (reps 32, 60 s workloads) writes the
    committed production pair byte for byte, then serves it from the
    cache."""
    m_r, m_w = train.get_default_models(cache_dir=str(tmp_path), seed=0,
                                        force=True)
    for op, m in (("read", m_r), ("write", m_w)):
        name = f"gbdt_{op}_s0.npz"
        assert (tmp_path / name).read_bytes() == \
            (gbdt.ASSETS / name).read_bytes()
        cached = train.get_default_models(cache_dir=str(tmp_path))[
            op == "write"]
        assert np.array_equal(cached.leaf, m.leaf)


def test_train_all_models_matches_reference_svm_and_gbdt():
    kw = dict(reps=2, duration_s=20.0, seed=0)
    got = train.train_all_models(device=CPU, **kw)
    want = ref_train.train_all_models(**kw)
    assert list(got) == list(want) == ["svm", "fcnn", "rnn", "tcn", "gbdt"]
    for name in ("svm", "gbdt"):
        assert (got[name].read_error, got[name].write_error) == \
            (want[name].read_error, want[name].write_error)
    for r in got.values():
        assert 0.0 <= r.read_error <= 1.0 and 0.0 <= r.write_error <= 1.0
