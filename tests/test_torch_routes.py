"""The routes the port takes where a kernel does not take a shape, against
the JAX package on the same numpy inputs made from a seed.

- An LSTM layer wider than any CTA of the recurrence kernels takes (H >=
  801 cells per direction with autograd, H >= 1,025 without) runs the scan
  route under backend "auto", as the JAX package's "auto" falls back to
  lax.scan where its kernels do not fit; an explicit "pallas" raises. The
  decision comes from the plan alone (ops/lstm_cell.py recurrence_fits), so
  the CPU takes the route the card takes: here the kernel route's entry
  points are replaced by ones that raise, and the layer still runs.
- A softmax over more than 704 classes (past K3's forward) fed by more than
  1,024 units (past K4b's passes) takes the materialized logits and the
  plain tail K5, as the JAX package does where its wide_plan refuses.

Tolerances as in tests/test_torch_lstm_grad.py and tests/test_torch_remat.py:
true f32 on both sides, sums in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu.models.lstm import lstm_forward as jax_lstm_forward
from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu_torch.models import lstm as lstm_mod
from lstm_rnn_tpu_torch.models.lstm import (kernel_route, lstm_forward,
                                            lstm_forward_streaming)
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.ops import softmax_ce as sc
from lstm_rnn_tpu_torch.ops.lstm_cell import recurrence_fits, recurrence_plan
from lstm_rnn_tpu_torch.ops.masking import pattypes_from_lengths
from lstm_rnn_tpu_torch.parallel import sequence as seq_mod

DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H, need_grad, fits", [
    (125, True, True), (800, True, True), (801, True, False),
    (801, False, True), (1024, False, True), (1025, False, False),
    (1025, True, False)])
def test_recurrence_fits_reads_the_plan(H, need_grad, fits, dtype):
    """A layer takes the kernels where the forward's plan is ok and, when
    it trains, the BPTT's too: 800 cells per direction train on them, 801
    do not; 1,024 serve on them, 1,025 do not."""
    assert recurrence_fits(H, dtype, need_grad) is fits
    assert recurrence_fits(H, dtype, need_grad) == (
        recurrence_plan(H, dtype, "fwd")["ok"]
        and (not need_grad or recurrence_plan(H, dtype, "bwd")["ok"]))


@pytest.mark.parametrize("need_grad", [True, False])
def test_kernel_route_by_backend(need_grad):
    H = 801 if need_grad else 1025
    assert kernel_route("auto", 125, torch.float32, need_grad)
    assert kernel_route("pallas", 125, torch.float32, need_grad)
    assert not kernel_route("scan", 125, torch.float32, need_grad)
    assert not kernel_route("auto", H, torch.float32, need_grad)
    assert not kernel_route("scan", H, torch.float32, need_grad)
    with pytest.raises(ValueError, match="lstm_backend=pallas"):
        kernel_route("pallas", H, torch.float32, need_grad)
    with pytest.raises(ValueError, match="backend must be one of"):
        kernel_route("mosaic", 125, torch.float32, need_grad)


def _refuse(*_a, **_k):
    raise AssertionError("the kernel route ran")


def _layer(H, seed, D=2, T=3, B=2, P=4):
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.uniform(-0.1, 0.1, s).astype(np.float32)  # noqa: E731
    params = {"W_in": u(D, P, 4, H), "W_rec": u(D, H, 4, H), "b": u(D, 4, H),
              "peep": u(D, 3, H)}
    x = rng.randn(T, B, P).astype(np.float32)
    pt = np.asarray(pattypes_from_lengths([T, T - 1], T, B))
    dy = rng.randn(T, B, D * H).astype(np.float32)
    return params, x, pt, dy


@functools.lru_cache(maxsize=None)
def _jax_layer(H, grad):
    params, x, pt, dy = _layer(H, H)
    f = lambda p: jax_lstm_forward(  # noqa: E731
        p, jnp.asarray(x), jnp.asarray(pt), 0.7, True, backend="scan")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    if not grad:
        return np.asarray(f(jp)), None
    y, vjp = jax.vjp(f, jp)
    (g,) = vjp(jnp.asarray(dy))
    return np.asarray(y), {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("H, grad", [(801, True), (1025, False)])
def test_wide_layer_takes_the_scan_route_and_matches_jax(H, grad,
                                                          monkeypatch):
    """backend "auto" trains a BLSTM of 801 cells per direction and serves
    one of 1,025 on the scan route, with the JAX package's values and
    gradients; the kernel route, replaced by a refusal, never runs."""
    for name in ("lstm_scan_fused", "_remat_fused"):
        monkeypatch.setattr(lstm_mod, name, _refuse)
    want_y, want_g = _jax_layer(H, grad)
    params, x, pt, dy = _layer(H, H)
    tp = {k: torch.tensor(v, requires_grad=grad) for k, v in params.items()}
    with torch.set_grad_enabled(grad):
        y = lstm_forward(tp, torch.tensor(x), torch.tensor(pt), 0.7, True,
                         backend="auto")
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=0, atol=1e-5)
    if grad:
        grads = torch.autograd.grad(y, list(tp.values()), torch.tensor(dy))
        for (k, got) in zip(tp, grads):
            w = want_g[k]
            np.testing.assert_allclose(
                got.numpy(), w, rtol=0,
                atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=k)


@pytest.mark.parametrize("H, grad", [(801, True), (1025, False)])
def test_explicit_pallas_raises_on_a_wide_layer(H, grad):
    params, x, pt, _ = _layer(H, H)
    tp = {k: torch.tensor(v, requires_grad=grad) for k, v in params.items()}
    with pytest.raises(ValueError, match="lstm_backend=pallas"), \
            torch.set_grad_enabled(grad):
        lstm_forward(tp, torch.tensor(x), torch.tensor(pt), 0.7, True,
                     backend="pallas")


def test_wide_layer_under_remat_takes_the_scan_route(monkeypatch):
    """--remat_blocks on a layer the kernels do not take checkpoints the
    scan route, as the JAX package's remat always does: the same values
    and gradients as the layer without remat."""
    for name in ("lstm_scan_fused", "_remat_fused"):
        monkeypatch.setattr(lstm_mod, name, _refuse)
    params, x, pt, dy = _layer(801, 3)
    out = []
    for k in (0, 2):
        tp = {n: torch.tensor(v, requires_grad=True)
              for n, v in params.items()}
        y = lstm_forward(tp, torch.tensor(x), torch.tensor(pt), 0.7, True,
                         backend="auto", remat_blocks=k)
        out.append((y, torch.autograd.grad(y, list(tp.values()),
                                           torch.tensor(dy))))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=1e-6)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_wide_streaming_layer_takes_the_scan_route(monkeypatch):
    """A unidirectional layer of 1,025 cells streams on the scan route:
    the chunk's output and carry are backend "scan"'s."""
    monkeypatch.setattr(lstm_mod, "_streaming_fused", _refuse)
    params, x, pt, _ = _layer(1025, 5, D=1)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    carry = (torch.zeros(1, 2, 1025), torch.zeros(1, 2, 1025))
    with torch.inference_mode():
        got = lstm_forward_streaming(tp, torch.tensor(x), torch.tensor(pt),
                                     0.7, carry, backend="auto")
        want = lstm_forward_streaming(tp, torch.tensor(x), torch.tensor(pt),
                                      0.7, carry, backend="scan")
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


def test_wide_layer_on_the_seq_mesh_takes_the_scan_route(monkeypatch):
    """Sequence parallelism routes a layer the kernels do not take to its
    scan wavefront, with the values of backend "scan"."""
    monkeypatch.setattr(seq_mod, "fused_wavefront", _refuse)
    params, x, pt, _ = _layer(801, 7, T=4)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xs = list(torch.tensor(x).split(2))
    pts = list(torch.tensor(pt).split(2))
    mesh = [torch.device("cpu")] * 2
    got = seq_mod.lstm_forward_seq(tp, xs, pts, 0.7, True, mesh,
                                   backend="auto")
    want = seq_mod.lstm_forward_seq(tp, xs, pts, 0.7, True, mesh,
                                    backend="scan")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ----------------------------------------------- the tail past K3 and K4b
WIDE_P_LAYERS = [
    {"name": "input", "type": "input", "size": 4},
    {"name": "l1", "type": "feedforward_tanh", "size": 1025, "bias": 1.0},
    {"name": "output", "type": "softmax", "size": 705, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": 705},
]


def test_route_predicates_at_the_limits():
    assert sc.proj_tail_fits(704, sc.H100_SMEM_OPTIN)
    assert not sc.proj_tail_fits(705, sc.H100_SMEM_OPTIN)
    assert sc.wide_tail_fits(1024) and not sc.wide_tail_fits(1025)
    assert sc.wide_tail_fits(1) and not sc.wide_tail_fits(0)


def test_wide_softmax_over_a_wide_layer_takes_k5_and_matches_jax(
        monkeypatch):
    """A 705-class softmax fed by 1,025 units: the fused tail takes the
    materialized logits and K5 (its twin here), with the JAX package's
    loss, count and gradients (its hidden width, not a 128 multiple, sends
    it to the same plain tail in interpret mode)."""
    calls = []
    for name in ("plain_fwd_reference", "softmax_ce_fwd_reference",
                 "softmax_ce_wide_fwd_reference"):
        f = getattr(sc, name)
        monkeypatch.setattr(sc, name, functools.partial(
            lambda f, n, *a, **k: calls.append(n) or f(*a, **k), f, name))
    rng = np.random.RandomState(13)
    Tn, Bn = 5, 3
    x = rng.randn(Tn, Bn, 4).astype(np.float32)
    pt = np.asarray(pattypes_from_lengths([5, 3, 1], Tn, Bn))
    tc = rng.randint(0, 705, (Tn, Bn)).astype(np.int32)
    tc[pt == 0] = -1

    jnet = JaxNetwork(WIDE_P_LAYERS, backend="scan")
    jnet.init_params(5)
    (e_j, c_j), g_j = jax.value_and_grad(
        lambda p: jnet.loss_and_count_fused(
            p, jnp.asarray(x), jnp.asarray(tc), jnp.asarray(pt),
            padded=False, interpret=True), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jnet.params))

    net = Network(WIDE_P_LAYERS)
    net.init_params(5)
    params = net.device_params("cpu")
    leaves = [params[n][k] for n in sorted(params) for k in sorted(params[n])]
    for v in leaves:
        v.requires_grad_(True)
    err, cnt = net.loss_and_count_fused(params, torch.tensor(x),
                                        torch.tensor(tc), torch.tensor(pt))
    grads = torch.autograd.grad(err, leaves)
    assert calls == ["plain_fwd_reference"]
    assert err.item() == pytest.approx(float(e_j), rel=1e-5)
    assert cnt.item() == int(c_j)
    want = [g_j[n][k] for n in sorted(params) for k in sorted(params[n])]
    for got, w in zip(grads, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * scale)
    # one unit fewer takes K4 (its twin here)
    layers = [dict(s) for s in WIDE_P_LAYERS]
    layers[1]["size"] = 1024
    net = Network(layers)
    net.init_params(5)
    net.loss_and_count_fused(net.device_params("cpu"), torch.tensor(x),
                             torch.tensor(tc), torch.tensor(pt))
    assert calls[-1] == "softmax_ce_wide_fwd_reference"
