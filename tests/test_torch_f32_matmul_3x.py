"""--f32_matmul 3x in the port (ops/gemm.py F32_MATMUL_3X) against the JAX
package's 3x mode (lstm_rnn_tpu/ops/lstm_cell.py F32_MATMUL_3X and
`_kdot(..., use3=True)`), on the CPU: the split product of every
transpose pattern the GEMM engine takes, one BLSTM layer's forward and
gradients, the K4 tail and the K3 tail's 3x route, the epoch against the
float64 oracle, and the CLI.

On the CPU the port runs its twins, which split the same products as the
Hopper kernels (csrc/gemm.cuh's gemm3x_kernel, csrc/softmax_ce_wide.cu's
wide_bwd_3x_kernel); the JAX side runs its Pallas kernels in interpret
mode with its switch set and restored (as tests/test_pallas_cell.py's
test_f32_matmul_3x_close_to_exact does), at narrow widths. The port's
recurrence keeps its step product in exact f32 where the JAX kernels
split it too: the comparisons of whole layers hold at that test's bounds,
which the 3x error contract sets (about 5e-7 relative a product). The
kernels are held against the twins on the card
(tests/test_torch_kernels_cuda.py).
"""

import contextlib
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu.ops import lstm_cell as jax_lc
from lstm_rnn_tpu.ops.lstm_cell import lstm_scan_fused as jax_lstm
from lstm_rnn_tpu.ops.softmax_ce import softmax_ce_proj_fused as jax_proj
from lstm_rnn_tpu.ops.softmax_ce import softmax_ce_wide_fused as jax_wide
from lstm_rnn_tpu.ops.softmax_ce import wide_plan
from lstm_rnn_tpu_torch import cli
from lstm_rnn_tpu_torch import network as port_network
from lstm_rnn_tpu_torch.data.dataset import DataSet
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.ops import gemm as ge
from lstm_rnn_tpu_torch.ops import softmax_ce as sc
from lstm_rnn_tpu_torch.ops.gemm import View
from lstm_rnn_tpu_torch.ops.lstm_cell import lstm_scan_fused
from lstm_rnn_tpu_torch.trainer import Trainer
from tests.test_data import _write_classification_nc
from tests.test_torch_trainer import LAYERS, TRAIN_LENGTHS

CSRC = Path(__file__).resolve().parents[1] / "lstm_rnn_tpu_torch" / "csrc"
H100_SMEM_OPTIN = 232_448


@contextlib.contextmanager
def three_pass():
    """The port's switch on, restored after."""
    before = ge.F32_MATMUL_3X
    ge.F32_MATMUL_3X = True
    try:
        yield
    finally:
        ge.F32_MATMUL_3X = before


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------- the split product
def _case(use, M=70, N=90, K=300, seed=0):
    """use's operands at [M, N, K], laid out as the engine reads them, and
    the JAX kernel's dot_general dimension numbers of that product."""
    ta, tb = ge.TRANSPOSE[use]
    rng = np.random.RandomState(seed + ge.USES.index(use))
    npairs = 2 if use == "dx" else 1
    a = [(rng.randn(*((K, M) if ta else (M, K)))).astype(np.float32)
         for _ in range(npairs)]
    b = [(0.3 * rng.randn(*((N, K) if tb else (K, N)))).astype(np.float32)
         for _ in range(npairs)]
    dims = (((0 if ta else 1,), (1 if tb else 0,)), ((), ()))
    return a, b, dims


def _engine_twin(use, a, b, M, N, K, x3):
    ta, tb = ge.TRANSPOSE[use]
    av = [View(torch.tensor(t), 0, t.shape[1], *t.shape) for t in a]
    bv = [View(torch.tensor(t), 0, t.shape[1], *t.shape) for t in b]
    kw = {}
    if use == "proj":
        kw = dict(bias=torch.zeros(1, N), bias_mult=0.0)
    elif use in ge.SPLIT_USES:
        kw = dict(nsplit=3)
    elif use == "dx":
        kw = dict(ngroups=2)
    out = ge.gemm_reference(use, av, bv, M, N, K, x3=x3, **kw)
    return out.reshape(M, N).numpy()


@pytest.mark.parametrize("use", ge.USES)
def test_split_twin_matches_jax_kdot(use):
    """The engine's twin in 3x (ops/gemm.py gemm_reference(x3=True), each
    product hi.hi + hi.lo + lo.hi of RN-split f32 operands) against the
    JAX kernels' _kdot(..., use3=True) on the same operands, for every
    transpose pattern and epilogue the engine takes, within 1e-6 of the
    largest entry (f32 sums in another order); the 1-pass bf16 product,
    the control, lies far outside, and the exact f32 product within the
    3x contract (2^-14 of the largest entry)."""
    M, N, K = 70, 90, 300
    a, b, dims = _case(use, M, N, K)

    def kdot(x, y, use3):
        return np.asarray(jax_lc._kdot(jnp.asarray(x), jnp.asarray(y), dims,
                                       jax.lax.Precision.HIGHEST, use3))

    want = sum(kdot(x, y, True) for x, y in zip(a, b))
    got = _engine_twin(use, a, b, M, N, K, x3=True)
    assert _rel(got, want) < 1e-6
    exact = sum(kdot(x.astype(np.float64), y.astype(np.float64), False)
                for x, y in zip(a, b))
    assert _rel(got, exact) < 2.0 ** -14
    bf = [np.asarray(jnp.asarray(t).astype(jnp.bfloat16), np.float32)
          for t in a + b]
    one_pass = sum(kdot(x, y, False) for x, y in zip(bf[:len(a)],
                                                     bf[len(a):]))
    assert _rel(one_pass, want) > 1e-4
    # the mode changes the product: x3=False is true f32
    assert _rel(_engine_twin(use, a, b, M, N, K, x3=False), exact) < 1e-6


def test_split_rounds_to_nearest_even():
    """hi = RN(a) and lo = RN(a - hi), as JAX's astype and the kernels'
    __float2bfloat16_rn: a tie rounds to the even bf16, a - hi is exact,
    zeros split to zeros (the engine's zero-filled edges)."""
    one = np.float32(1.0)
    tie = np.float32(1.0 + 2.0 ** -8)  # halfway between 1 and 1 + 2^-7
    v = torch.tensor([tie, -tie, 0.0, one, 3.14159265], dtype=torch.float32)
    hi, lo = ge.split_bf16(v)
    assert hi[0] == 1.0 and hi[1] == -1.0  # to even, not away
    assert lo[0] == 2.0 ** -8 and lo[1] == -(2.0 ** -8)
    assert hi[2] == 0 and lo[2] == 0 and lo[3] == 0
    np.testing.assert_array_equal(
        hi.numpy(), np.asarray(jnp.asarray(v.numpy()).astype(jnp.bfloat16),
                               np.float32))
    assert ((hi + lo) - v).abs().max() <= 2.0 ** -16 * v.abs().max()


def test_split_uses_need_float32():
    with pytest.raises(ValueError, match="float32"):
        ge.gemm_reference("dW_in", [], [], 1, 1, 1, x3=True,
                          compute_dtype=torch.bfloat16)
    assert not ge.use3(torch.float32)
    with three_pass():
        assert ge.use3(torch.float32) and not ge.use3(torch.bfloat16)
        assert not ge.use3(torch.float64)
    assert not ge.use3(torch.float32)


# ------------------------------------------------------- the LSTM layer
T, B, H, P = 12, 8, 128, 128
LENGTHS = np.array([12, 5, 0, 12, 1, 7, 3, 11], np.int32)
BIAS_MULT = 0.7


def _layer_inputs():
    rng = np.random.RandomState(3)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)  # noqa
    x = rng.randn(T, B, P).astype(np.float32)
    dh = (4.0 * rng.randn(T, B, 2 * H)).astype(np.float32)
    return (x, u(2, P, 4 * H), u(2, H, 4 * H), u(2, 3, H), u(2, 4 * H)), dh


@functools.lru_cache(maxsize=None)
def _jax_layer(use3):
    args, dh = _layer_inputs()
    f = functools.partial(jax_lstm, lengths=jnp.asarray(LENGTHS),
                          bias_mult=BIAS_MULT, clip=True, interpret=True,
                          compute_dtype=jnp.float32, need_dx=True)
    before = jax_lc.F32_MATMUL_3X
    jax_lc.F32_MATMUL_3X = use3
    try:
        h, vjp = jax.vjp(lambda *a: f(*a), *map(jnp.asarray, args))
        grads = vjp(jnp.asarray(dh))
    finally:
        jax_lc.F32_MATMUL_3X = before
    return np.asarray(h), [np.asarray(g) for g in grads]


def _port_layer():
    args, dh = _layer_inputs()
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    h = lstm_scan_fused(*ts, torch.tensor(LENGTHS), BIAS_MULT, torch.float32)
    grads = torch.autograd.grad(h, ts, torch.tensor(dh))
    return h.detach().numpy(), [g.numpy() for g in grads]


def test_blstm_layer_3x_matches_jax_3x():
    """One BLSTM layer's h and its five gradients (dx, dW_in, dW_rec,
    dpeep, dbias) in 3x mode against the JAX kernels' 3x mode, at
    test_pallas_cell.py's 3x bounds (h within 5e-5, each gradient within
    1e-4 of its largest entry); the port's f32 layer differs from its 3x
    layer (the switch reached the twins), and the JAX f32 layer is the
    control on the same bounds."""
    h_j, g_j = _jax_layer(True)
    with three_pass():
        h, g = _port_layer()
    np.testing.assert_allclose(h, h_j, rtol=0, atol=5e-5)
    for name, got, want in zip(("dx", "dW_in", "dW_rec", "dpeep", "dbias"),
                               g, g_j):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    h32, g32 = _port_layer()
    assert not np.array_equal(h32, h)
    assert any(not np.array_equal(a, b) for a, b in zip(g32, g))
    h_j32, g_j32 = _jax_layer(False)
    np.testing.assert_allclose(h32, h_j32, rtol=0, atol=5e-5)


# ------------------------------------------------------------ the tails
N, PT, PP = 128, 100, 128
G = 0.37


def _tail_inputs(S):
    rng = np.random.RandomState(S)
    h = (0.5 * rng.randn(N, PT)).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, (PT, S)).astype(np.float32)
    b = rng.uniform(-0.3, 0.3, S).astype(np.float32)
    tc = rng.randint(0, S, N).astype(np.int32)
    tc[[3, 40]] = -1
    return h, w, b, tc


@functools.lru_cache(maxsize=None)
def _jax_tail(kind, S):
    h, w, b, tc = _tail_inputs(S)
    if kind == "wide":
        sp = wide_plan(N, PP, S, jnp.float32)[0]
        tail = jax_wide
    else:
        sp = -(-S // 128) * 128
        tail = jax_proj
    hp = jnp.asarray(np.pad(h, ((0, 0), (0, PP - PT))))
    wp = jnp.asarray(np.pad(w, ((0, PP - PT), (0, sp - S))))
    bp = jnp.asarray(np.pad(b, (0, sp - S)))
    f = functools.partial(tail, targets=jnp.asarray(tc[:, None]), S=S,
                          bias_mult=0.8, interpret=True,
                          compute_dtype=jnp.float32)
    before = jax_lc.F32_MATMUL_3X
    jax_lc.F32_MATMUL_3X = True
    try:
        (loss, cnt), vjp = jax.vjp(lambda *a: f(*a), hp, wp, bp)
        dh, dw, db = vjp((jnp.asarray(G, jnp.float32),
                          jnp.zeros((), jnp.int32)))
    finally:
        jax_lc.F32_MATMUL_3X = before
    return (float(loss), int(cnt), np.asarray(dh)[:, :PT],
            np.asarray(dw)[:PT, :S], np.asarray(db)[:S])


@pytest.mark.parametrize("kind, S", [("proj", 183), ("wide", 900)])
def test_tails_3x_match_jax_3x(kind, S):
    """K4's tail (softmax_ce_wide_fused: the logits, K4b's dW and dh in
    3x) and K3's 3x route (softmax_ce_3x_fused: the engine's 3x logits,
    K5, the engine's 3x dh and dW) against the JAX tails' 3x kernels: the
    loss within 1e-4 relative, the count equal, dh, dW and db within 1e-4
    of their largest entries (test_pallas_cell.py's 3x bounds)."""
    loss_j, cnt_j, dh_j, dw_j, db_j = _jax_tail(kind, S)
    h, w, b, tc = _tail_inputs(S)
    ts = [torch.tensor(a, requires_grad=True) for a in (h, w, b)]
    with three_pass():
        if kind == "wide":
            loss, cnt = sc.softmax_ce_wide_fused(*ts, torch.tensor(tc), S,
                                                 0.8, torch.float32)
        else:
            loss, cnt = sc.softmax_ce_3x_fused(*ts, torch.tensor(tc), S,
                                               0.8)
        grads = torch.autograd.grad(loss, ts, torch.tensor(G))
    assert abs(float(loss.detach()) - loss_j) < 1e-4 * abs(loss_j)
    assert int(cnt) == cnt_j
    for name, got, want in zip(("dh", "dW", "db"), grads, (dh_j, dw_j, db_j)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
    assert not grads[0][[3, 40]].any()  # dummy rows get no gradient


def test_3x_tail_route_needs_the_switch():
    h, w, b, tc = (torch.tensor(a) for a in _tail_inputs(183))
    with pytest.raises(RuntimeError, match="3x"):
        sc.softmax_ce_3x_fused(h, w, b, tc, 183, 0.8)


def test_k4b_3x_tiles_follow_the_kernel_source():
    """wide_bwd_plan(x3=True) states K4b's 3x launch: its rows a tile are
    the source's kBwdRows3x, and its shared memory (Bwd3x::kSmem: two
    stages of the f32 logits, h's two bf16 planes and the rows'
    constants) fits an H100; the engine's 3x ring (kWg3Smem) fits too."""
    src = (CSRC / "softmax_ce_wide.cu").read_text()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)
                   .group(1))

    rows, stages = const(src, "kBwdRows3x"), const(src, "kBwd3xStages")
    cols, pas = const(src, "kBwdCols"), const(src, "kBwdPass")
    assert sc._BWD_ROWS_3X == rows
    for line in ("kZBytes = kRows * kBwdCols * 4;",
                 "kHPlane = kRows * kBwdPass * 2;",
                 "kHBytes = 2 * kHPlane;",
                 "kStageBytes = kZBytes + kHBytes + kRows * kRowBytes;",
                 "kSmem = kBwd3xStages * kStageBytes + 1024;"):
        assert f"static constexpr int {line}" in src, line
    smem = stages * (rows * cols * 4 + 2 * rows * pas * 2 + rows * 32) + 1024
    assert smem <= H100_SMEM_OPTIN
    plan = sc.wide_bwd_plan(25_000, 250, 10_112, False, x3=True)
    assert plan["rows"] == rows and plan["ntiles"] == 391
    # no split sums more than 16 tiles (1,024 rows): 25 splits of 16 or 7
    assert plan["nsplit"] == 25
    for N_ in (64, 1000, 25_000, 70_000):
        p3 = sc.wide_bwd_plan(N_, 250, 10_112, False, x3=True)
        tps = -(-p3["ntiles"] // p3["nsplit"])
        assert tps <= sc._BWD_3X_TILES
        assert (p3["nsplit"] - 1) * tps < p3["ntiles"] <= p3["nsplit"] * tps
    gemm_src = (CSRC / "gemm.cuh").read_text()
    assert ("constexpr int kWg3Smem = kWgStages * 4 * kWgTileBytes + 1024;"
            in gemm_src)
    ring = const(gemm_src, "kWgStages") * 4 * (128 * 64 * 2) + 1024
    assert ring <= H100_SMEM_OPTIN


# ------------------------------------------------------------ the epoch
def _epoch(tmp_path, x3, compute_dtype="float32", backend="auto"):
    nc = str(tmp_path / "t.nc")
    _write_classification_nc(nc, TRAIN_LENGTHS, seed=1)
    ds = DataSet([nc], parallel_sequences=3, sort_by_length=True,
                 prefetch=False)
    net = Network(LAYERS, backend=backend, compute_dtype=compute_dtype)
    net.init_params(7)
    params0 = {k: {kk: np.asarray(vv, np.float64) for kk, vv in v.items()}
               for k, v in net.params.items()}
    tr = Trainer(net, ds, learning_rate=0.05, momentum=0.9, max_epochs=1,
                 hybrid_online_batch=True, device="cpu")
    ctx = three_pass() if x3 else contextlib.nullcontext()
    with ctx:
        tr.train_epoch()
    return tr, params0, ds, net


def test_3x_epoch_drift_vs_float64_oracle(tmp_path, monkeypatch):
    """The JAX package's 3x safety bound (tests/test_end_to_end.py:349-
    416, which reads a corpus not shipped here) on test_torch_trainer.py's
    corpus: one stochastic epoch of the kernel route in 3x against the
    float64 oracle drifts less than max(5 x the f32 epoch's drift, 1e-3)
    and less than 1e-2 of each update's scale, and its loss lies within
    1e-3 of the f32 epoch's. The 3x epoch takes the 3x tail route."""
    from tests import oracle_net
    calls = []
    route = port_network.softmax_ce_3x_fused
    monkeypatch.setattr(port_network, "softmax_ce_3x_fused",
                        lambda *a: calls.append(1) or route(*a))
    tr32, params0, ds, net = _epoch(tmp_path, False)
    assert not calls
    tr3, _, _, _ = _epoch(tmp_path, True)
    assert calls  # the fused tail took the 3x route
    fracs = [(f.inputs, f.targets, f.pattypes) for f in ds.fractions()]
    layer_lr = {s.name: s.learning_rate for s in net.specs
                if s.learning_rate >= 0}
    p_ref, _, _, _ = oracle_net.train_epoch(
        net.specs, params0, fracs, lr=0.05, momentum=0.9, layer_lr=layer_lr,
        stochastic=True)

    def drift(tr):
        worst = 0.0
        for name in p_ref:
            for kk in p_ref[name]:
                upd_ref = p_ref[name][kk] - params0[name][kk]
                upd = tr.params[name][kk].detach().double().numpy() \
                    - params0[name][kk]
                scale = np.abs(upd_ref).max() + 1e-12
                worst = max(worst, float(np.abs(upd - upd_ref).max()
                                         / (scale + 5e-8 / 2e-3)))
        return worst

    d32, d3 = drift(tr32), drift(tr3)
    assert d32 < 2e-3
    assert d3 < max(5 * d32, 1e-3) and d3 < 1e-2
    e32, e3 = tr32.cur_training_error, tr3.cur_training_error
    assert abs(e3 - e32) < 1e-3 * abs(e32)
    assert any(not torch.equal(tr3.params[n][k], tr32.params[n][k])
               for n in tr32.params for k in tr32.params[n])


def test_3x_is_nothing_in_bfloat16_mode(tmp_path):
    """In bf16 mode the switch changes no value, as in the JAX package."""
    tr16, _, _, _ = _epoch(tmp_path, False, "bfloat16")
    tr16x, _, _, _ = _epoch(tmp_path, True, "bfloat16")
    for n in tr16.params:
        for k in tr16.params[n]:
            assert torch.equal(tr16.params[n][k], tr16x.params[n][k])


# ------------------------------------------------------------- the CLI
def test_cli_trains_in_3x(tmp_path, capsys):
    """cli.main(--train true --f32_matmul 3x) on test_torch_cli.py's
    training run: the 3x twins move the weights off the f32 run's, within
    the 3x contract after 2 epochs (1e-4 of each section's largest
    entry), the epoch errors lie within 1e-3 relative of the f32 run's
    (tests/test_end_to_end.py:415-416), and the switch is off again after
    the run."""
    from tests.test_torch_cli import _train_args
    from lstm_rnn_tpu_torch.io_currennt import load_network_json
    runs = {}
    for name, extra in (("f32", []), ("3x", ["--f32_matmul", "3x"])):
        out = str(tmp_path / f"{name}.jsn")
        assert cli.main(_train_args(tmp_path, out) + extra) == 0
        runs[name] = (load_network_json(out)["weights"],
                      _epoch_errors(capsys.readouterr().out))
        assert not ge.F32_MATMUL_3X
    (w32, e32), (w3, e3) = runs["f32"], runs["3x"]
    moved = False
    for layer in w32:
        for part in w32[layer]:
            a, b = np.asarray(w32[layer][part]), np.asarray(w3[layer][part])
            if a.size:
                np.testing.assert_allclose(b, a, rtol=0,
                                           atol=1e-4 * np.abs(a).max())
                moved |= not np.array_equal(a, b)
    assert moved
    assert len(e32) == len(e3) == 2
    np.testing.assert_allclose(e3, e32, rtol=1e-3)


def _epoch_errors(text):
    """The training and validation errors of each row of the CLI's epoch
    table (its fields are separated by '|')."""
    rows = []
    for line in text.splitlines():
        f = line.split("|")
        if len(f) > 4 and f[0].strip().isdigit():
            rows.append([float(f[k].split()[-1]) for k in (2, 3)])
    return rows
