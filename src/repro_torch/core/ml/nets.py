"""Neural baselines (paper Table IV): FC-NN, vanilla RNN, TCN — in torch.

The paper feeds flattened history to the FC-NN and per-timestep vectors to
the RNN/TCN. Our feature layout is [metrics_t (6), metrics_{t-1} (6),
config (2)] + candidate theta (2); sequence models receive the two metric
timesteps as a length-2 sequence with the static (config, theta) features
appended to every step. Training: Adam + BCE, mini-batches, early stop.

Each architecture is an ``nn.Module`` at the reference's widths. ``init``
draws its weights from an explicit ``torch.Generator`` (other draws than
the reference's ``jax.random`` ones); :func:`net_params_from_reference`
carries the reference's weights across instead. :func:`train_net` keeps
the reference's arithmetic rather than a torch optimizer's: the stable
BCE, the hand-written Adam with ``weight_decay * p`` inside the ``lr``
product, the batch order of a PCG64 generator and the early stop on
validation error (one read back to the host per epoch).

Every product is a float32 ``matmul``; the TCN's causal convolution is
written as one product per tap on shifted slices rather than
``F.conv1d``, which cuDNN runs in TF32 on Hopper by default.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

METRICS_PER_STEP = 6
N_STEPS = 2                 # history k=1 => [s_{t-1}, s_t]
STATIC_DIM = 10             # deltas (6) + current config (2) + theta (2)

State = Dict[str, torch.Tensor]


def _split_sequence(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, 22) -> sequence (n, 2, 6) ordered [t-1, t], static (n, 10)."""
    cur = X[:, 0:METRICS_PER_STEP]
    prev = X[:, METRICS_PER_STEP:2 * METRICS_PER_STEP]
    seq = torch.stack([prev, cur], dim=1)
    static = X[:, 2 * METRICS_PER_STEP:]
    return seq, static


def _steps(X: torch.Tensor) -> torch.Tensor:
    """(n, 22) -> (n, 2, 16): each step's metrics, then the static
    features."""
    seq, static = _split_sequence(X)
    return torch.cat([seq, static[:, None, :].expand(-1, N_STEPS,
                                                     STATIC_DIM)], dim=-1)


def _linear(n_in: int, n_out: int) -> nn.Linear:
    # weights come from ``init`` or the reference: skip torch's own draw
    return nn.utils.skip_init(nn.Linear, n_in, n_out)


def _dense_init(gen: torch.Generator, n_in: int,
                n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """He-normal (n_out, n_in) weight and zero bias of one dense layer."""
    w = torch.randn((n_in, n_out), generator=gen) * math.sqrt(2.0 / n_in)
    return w.T.contiguous(), torch.zeros(n_out)


def _dense_state(prefix: str, wb: Tuple[torch.Tensor, torch.Tensor]) -> State:
    return {f"{prefix}.weight": wb[0], f"{prefix}.bias": wb[1]}


# --- FC-NN --------------------------------------------------------------------
class FCNN(nn.Module):
    name = "fcnn"

    def __init__(self, in_dim: int, hidden: Tuple[int, ...] = (64, 64)):
        super().__init__()
        self.in_dim = in_dim
        self.hidden = tuple(hidden)
        dims = (in_dim,) + self.hidden + (1,)
        self.layers = nn.ModuleList(_linear(dims[i], dims[i + 1])
                                    for i in range(len(dims) - 1))

    def init(self, gen: torch.Generator) -> State:
        state: State = {}
        for i, layer in enumerate(self.layers):
            state.update(_dense_state(f"layers.{i}", _dense_init(
                gen, layer.in_features, layer.out_features)))
        return state

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        h = X
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return self.layers[-1](h)[:, 0]


# --- vanilla RNN ---------------------------------------------------------------
class VanillaRNN(nn.Module):
    name = "rnn"

    def __init__(self, in_dim: int, hidden: int = 32):
        super().__init__()
        self.in_dim = in_dim           # full flattened dim (for API parity)
        self.hidden = hidden
        self.step_dim = METRICS_PER_STEP + STATIC_DIM
        self.wx = _linear(self.step_dim, hidden)
        self.wh = _linear(hidden, hidden)
        self.head = _linear(hidden, hidden)
        self.out = _linear(hidden, 1)

    def init(self, gen: torch.Generator) -> State:
        state: State = {}
        for name, (n_in, n_out) in (("wx", (self.step_dim, self.hidden)),
                                    ("wh", (self.hidden, self.hidden)),
                                    ("head", (self.hidden, self.hidden)),
                                    ("out", (self.hidden, 1))):
            state.update(_dense_state(name, _dense_init(gen, n_in, n_out)))
        return state

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        xs = _steps(X)
        h = X.new_zeros((X.shape[0], self.hidden))
        for t in range(N_STEPS):
            h = torch.tanh(self.wx(xs[:, t]) + self.wh(h))
        h = torch.relu(self.head(h))                  # nonlinear readout
        return self.out(h)[:, 0]


# --- TCN ------------------------------------------------------------------------
class TCN(nn.Module):
    name = "tcn"

    def __init__(self, in_dim: int, channels: int = 32, kernel: int = 2):
        super().__init__()
        self.in_dim = in_dim
        self.channels = channels
        self.kernel = kernel
        self.step_dim = METRICS_PER_STEP + STATIC_DIM
        # (out, in, kernel) weights, as torch lays out a Conv1d's
        self.conv1 = nn.utils.skip_init(nn.Conv1d, self.step_dim, channels,
                                        kernel)
        self.conv2 = nn.utils.skip_init(nn.Conv1d, channels, channels, kernel)
        self.out = _linear(channels, 1)

    def init(self, gen: torch.Generator) -> State:
        c, k = self.channels, self.kernel
        state: State = {}
        for name, c_in in (("conv1", self.step_dim), ("conv2", c)):
            w = (torch.randn((k, c_in, c), generator=gen)
                 * math.sqrt(2.0 / (k * c_in)))
            state[f"{name}.weight"] = w.permute(2, 1, 0).contiguous()
            state[f"{name}.bias"] = torch.zeros(c)
        state.update(_dense_state("out", _dense_init(gen, c, 1)))
        return state

    @staticmethod
    def _causal_conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        """x: (n, t, c_in) -> (n, t, c_out); step s sees steps s-k+1..s
        (left-padded with zeros). A cross-correlation, as the reference's
        ``conv_general_dilated``: tap j meets step s + j - (k - 1)."""
        k = conv.kernel_size[0]
        t = x.shape[1]
        xp = F.pad(x, (0, 0, k - 1, 0))
        y = xp[:, 0:t] @ conv.weight[:, :, 0].T
        for j in range(1, k):
            y = y + xp[:, j:j + t] @ conv.weight[:, :, j].T
        return y + conv.bias

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        xs = _steps(X)
        h = torch.relu(self._causal_conv(self.conv1, xs))
        h = torch.relu(self._causal_conv(self.conv2, h))
        return self.out(h[:, -1, :])[:, 0]


def net_params_from_reference(arch: nn.Module, params) -> State:
    """The reference's nested parameter dict (arrays, taken as NumPy) as
    ``arch``'s state: dense ``w`` (in, out) -> ``Linear.weight`` (out, in);
    conv ``w`` WIO (k, in, out) -> (out, in, k), unflipped (both sides
    cross-correlate)."""
    def t(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    def dense(p):
        return t(np.asarray(p["w"]).T), t(p["b"])

    def conv(p):
        return t(np.transpose(np.asarray(p["w"]), (2, 1, 0))), t(p["b"])

    if isinstance(arch, FCNN):
        pairs = {f"layers.{i}": dense(params[f"l{i}"])
                 for i in range(len(arch.layers))}
    elif isinstance(arch, VanillaRNN):
        pairs = {k: dense(params[k]) for k in ("wx", "wh", "head", "out")}
    elif isinstance(arch, TCN):
        pairs = {"conv1": conv(params["conv1"]),
                 "conv2": conv(params["conv2"]),
                 "out": dense(params["out"])}
    else:
        raise TypeError(f"no reference layout for {type(arch).__name__}")
    state: State = {}
    for prefix, wb in pairs.items():
        state.update(_dense_state(prefix, wb))
    return state


# ----------------------------------------------------------------------------
@dataclass
class NetModel:
    """A trained net with a numpy-facing predict_proba, on ``device``
    (``cuda`` unless another is named)."""
    module: nn.Module
    mu: np.ndarray
    sigma: np.ndarray
    name: str = "net"
    device: DeviceLike = None
    steps: int = 0                 # Adam updates that trained it

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.module.to(self.device)

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        Z = (np.asarray(X, np.float32) - self.mu) / self.sigma
        with torch.no_grad():
            logits = self.module(torch.as_tensor(Z, device=self.device))
            return torch.sigmoid(logits).cpu().numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        return (self.predict_proba(X) >= 0.5).astype(np.int32)


# --- shared trainer -------------------------------------------------------------
def _bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.clamp_min(logits, 0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def train_net(
    arch: nn.Module,
    X: np.ndarray,
    y: np.ndarray,
    X_val=None,
    y_val=None,
    epochs: int = 60,
    batch: int = 512,
    lr: float = 1e-3,
    weight_decay: float = 1e-4,
    seed: int = 0,
    patience: int = 25,
    device: DeviceLike = None,
) -> NetModel:
    """Train ``arch`` in place on ``device`` and wrap it as a NetModel."""
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    mu = X.mean(axis=0)
    sigma = X.std(axis=0) + 1e-6
    Z = torch.as_tensor((X - mu) / sigma, device=dev)
    Y = torch.as_tensor(y, device=dev)

    arch.load_state_dict(arch.init(torch.Generator().manual_seed(seed)))
    arch.to(dev)
    params = list(arch.parameters())
    # hand-rolled Adam, the reference's arithmetic
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    step = 0

    def update(xb: torch.Tensor, yb: torch.Tensor) -> None:
        nonlocal step
        grads = torch.autograd.grad(_bce(arch(xb), yb), params)
        step += 1
        c1, c2 = 1 - 0.9 ** step, 1 - 0.999 ** step
        with torch.no_grad():
            for p, g, m_, v_ in zip(params, grads, m, v):
                m_.copy_(0.9 * m_ + 0.1 * g)
                v_.copy_(0.999 * v_ + 0.001 * g * g)
                mh, vh = m_ / c1, v_ / c2
                p.copy_(p - lr * (mh / (torch.sqrt(vh) + 1e-8)
                                  + weight_decay * p))

    nprng = np.random.Generator(np.random.PCG64(seed))
    n = len(X)
    best = [p.detach().clone() for p in params]
    best_err, since = np.inf, 0
    has_val = X_val is not None
    if has_val:
        Zv = torch.as_tensor((np.asarray(X_val, np.float32) - mu) / sigma,
                             device=dev)
        Yv = np.asarray(y_val)

    for _ in range(epochs):
        order = torch.as_tensor(nprng.permutation(n), device=dev)
        for s in range(0, n, batch):
            idx = order[s:s + batch]
            update(Z[idx], Y[idx])
        if has_val:
            with torch.no_grad():
                pred = (arch(Zv) >= 0).cpu().numpy().astype(np.int32)
            err = float(np.mean(pred != Yv))
            if err < best_err - 1e-4:
                best_err, since = err, 0
                best = [p.detach().clone() for p in params]
            else:
                since += 1
                if since >= patience:
                    break
    if has_val:
        with torch.no_grad():
            for p, b in zip(params, best):
                p.copy_(b)
    return NetModel(module=arch, mu=mu, sigma=sigma, name=arch.name,
                    device=dev, steps=step)
