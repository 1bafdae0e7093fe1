"""--remat_blocks in the port against the JAX package, on the same numpy
inputs made from a seed: the plain softmax tail (K5, ops/softmax_ce.py)
against the JAX kernels in interpret mode, the LSTM checkpointed in K
time blocks (models/lstm.py, both routes) against the JAX package's
`lstm_forward(backend="scan", remat_blocks=K)`, the memory the
checkpointing saves, `Network.loss_and_count_fused` under remat, and the
CLI with the flag.

On the CPU the port's kernel route runs the kernels' plain twins; the
Hopper kernels are held against the twins on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu import cli as jax_cli
from lstm_rnn_tpu.models.lstm import lstm_forward as jax_lstm_forward
from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu.ops.masking import pattypes_from_lengths
from lstm_rnn_tpu.ops.softmax_ce import _fwd_impl
from lstm_rnn_tpu.ops.softmax_ce import softmax_ce_fused as jax_tail
from lstm_rnn_tpu_torch import cli
from lstm_rnn_tpu_torch.models.lstm import _lstm_scan, lstm_forward
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.ops import softmax_ce as sc
from tests.test_torch_cli import _setup, _train_args

# ------------------------------------------------------------ K5 twins
N = 64
G = 0.37  # the loss cotangent
DUMMY = (5, 17, 40)  # rows with target -1
# S up to 1,000 (K5f's warp body); 1,025 and 10,241, past the warp body
# and past the block's register holding, on a few rows
TAIL_CASES = [(S, dt) for S in (7, 183, 1000, 1025, 10241)
              for dt in ("float32", "bfloat16")]


def _rows(S):
    return N if S <= 1000 else 16


def _dummy(S):
    """the rows with target -1 among _tail_inputs(S)'s"""
    return [d for d in DUMMY if d < _rows(S)]


def _tail_inputs(S):
    n = _rows(S)
    rng = np.random.RandomState(S)
    a = (3.0 * rng.randn(n, S)).astype(np.float32)
    tc = rng.randint(0, S, n).astype(np.int32)
    tc[_dummy(S)] = -1
    # row 10: the maximum tied at classes 1 and 3 (the first argmax, 1,
    # counts; the target is 1)
    a[10] = 0.0
    a[10, 1] = a[10, 3] = 5.0
    tc[10] = 1
    # row 11: a range above 2 EXP_LIMIT: the largest logit's safeExp
    # saturates at REAL_MAX and the smallest underflows to 0
    a[11] = 0.0
    a[11, 2], a[11, 0] = 200.0, -200.0
    tc[11] = 0
    # row 12: logits at the LOG_ZERO limit and two maxima that saturate:
    # the exp sum overflows and every p is 0 (the loss takes
    # -log REAL_MIN); the target is not the first argmax
    a[12] = -3e30
    a[12, 3] = a[12, 4] = 0.0
    tc[12] = 4
    return a, tc


@functools.lru_cache(maxsize=None)
def _jax_tail(S, dtype):
    """loss, count, p and dz of the JAX kernels (interpret mode) on the
    128-lane-padded logits, sliced back to S columns."""
    a, tc = _tail_inputs(S)
    sp = -(-S // 128) * 128
    ap = jnp.asarray(np.pad(a, ((0, 0), (0, sp - S))))
    t2 = jnp.asarray(tc[:, None])
    store = jnp.dtype(dtype)
    (loss, cnt), vjp = jax.vjp(
        lambda x: jax_tail(x, t2, S, True, store), ap)
    dz, = vjp((jnp.asarray(G, jnp.float32), np.zeros((), jax.dtypes.float0)))
    _, _, p = _fwd_impl(ap, t2, S, True, store, want_p=True)
    f32 = lambda x: np.asarray(x, np.float32)[:, :S]  # noqa: E731
    return float(loss), int(cnt), f32(p), f32(dz)


@pytest.mark.parametrize("S, dtype", TAIL_CASES)
def test_k5_twins_match_jax_kernels(S, dtype):
    a, tc = _tail_inputs(S)
    loss_j, cnt_j, p_j, dz_j = _jax_tail(S, dtype)
    dt = getattr(torch, dtype)
    loss, cnt, p = sc.softmax_ce_fwd(torch.tensor(a), torch.tensor(tc), dt)
    dz = sc.softmax_ce_bwd(p, torch.tensor(tc), torch.tensor(G))
    assert p.dtype == dt and dz.dtype == torch.float32
    # f32: both take exp, log and the row sums in another order; the
    # count is the first argmax of the f32 p on both sides
    assert loss.item() == pytest.approx(loss_j, rel=1e-6)
    assert cnt.item() == cnt_j
    if dtype == "float32":
        p_tol = dz_tol = 1e-6
    else:
        # both round an f32 p that differs in its last bits: a rounding
        # flip moves p by one bf16 ulp (2^-7 of p at most), and dz (from
        # the stored p) by one ulp of its largest entry
        p_tol = 2.0 ** -7 * np.abs(p_j) + 1e-6
        dz_tol = 2.0 ** -7 * np.abs(dz_j).max()
    assert np.all(np.abs(p.float().numpy() - p_j) <= p_tol)
    assert np.all(np.abs(dz.numpy() - dz_j) <= dz_tol)
    # the rows the inputs were built for
    assert not dz[_dummy(S)].any()
    assert np.all(np.isfinite(dz.numpy()))
    assert p[12].float().abs().max().item() == 0.0


def test_k5_autograd_routes_through_both_kernels(monkeypatch):
    """softmax_ce_fused with a gradient stores p (the forward with want_p)
    and differentiates through K5b; without one the forward stores
    nothing. On the CPU the wrappers run the twins, counted here."""
    calls = []
    for name in ("plain_fwd_reference", "plain_dz_reference"):
        f = getattr(sc, name)
        monkeypatch.setattr(sc, name, functools.partial(
            lambda f, n, *a, **k: calls.append(n) or f(*a, **k), f, name))
    a, tc = _tail_inputs(7)
    at = torch.tensor(a, requires_grad=True)
    loss, cnt = sc.softmax_ce_fused(at, torch.tensor(tc), 7)
    (g,) = torch.autograd.grad(loss * G, at)
    assert calls == ["plain_fwd_reference", "plain_dz_reference"]
    np.testing.assert_allclose(g.numpy(), _jax_tail(7, "float32")[3],
                               rtol=0, atol=1e-6)
    with torch.no_grad():
        l2, c2 = sc.softmax_ce_fused(at, torch.tensor(tc), 7)
    assert (l2.item(), c2.item()) == (loss.item(), cnt.item())
    with pytest.raises(ValueError, match="columns"):
        sc.softmax_ce_fused(at, torch.tensor(tc), 8)


# -------------------------------------------------- the checkpointed LSTM
T, B, P, L = 7, 3, 5, 8
LENGTHS = [7, 4, 1]


def _lstm_inputs(bidirectional, seed):
    rng = np.random.RandomState(seed)
    d = 2 if bidirectional else 1
    h = L // d
    u = lambda *s: rng.uniform(-0.5, 0.5, s).astype(np.float32)  # noqa
    params = {"W_in": u(d, P, 4, h), "W_rec": u(d, h, 4, h),
              "b": u(d, 4, h), "peep": u(d, 3, h)}
    x = u(T, B, P) * 2
    g_out = u(T, B, L) * 2
    pt = pattypes_from_lengths(LENGTHS, T, B)
    return params, x, np.asarray(pt), g_out


@pytest.mark.parametrize("backend", ["scan", "auto"])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("remat_blocks", [2, 3])
def test_remat_lstm_matches_jax(backend, bidirectional, remat_blocks):
    """Both routes with remat_blocks=K (3 does not divide T = 7: zero-mask
    steps pad the last block) against the JAX package's checkpointed
    scan: the output and every gradient (the input's too)."""
    params, x, pt, g_out = _lstm_inputs(bidirectional, remat_blocks)

    def jloss(p, xx):
        y = jax_lstm_forward(p, xx, jnp.asarray(pt), 0.8, bidirectional,
                             backend="scan", remat_blocks=remat_blocks)
        return jnp.sum(y * g_out), y

    (_, y_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    y = lstm_forward(tp, tx, torch.tensor(pt), 0.8, bidirectional,
                     backend=backend, remat_blocks=remat_blocks)
    leaves = [tp[k] for k in sorted(tp)] + [tx]
    grads = torch.autograd.grad((y * torch.tensor(g_out)).sum(), leaves)
    want = [g_j[0][k] for k in sorted(tp)] + [g_j[1]]
    # true f32 on both sides, sums in another order (the bound of
    # tests/test_lstm_parity.py's remat test)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-7)
    for name, got, w in zip(sorted(tp) + ["x"], grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_remat_refuses_return_carry():
    acts = torch.zeros(4, 1, 2, 4, 3)
    with pytest.raises(ValueError, match="return_carry"):
        _lstm_scan(acts, torch.zeros(1, 3, 4, 3), torch.zeros(1, 3, 3),
                   torch.ones(4, 1, 2, 1), torch.float32,
                   return_carry=True, remat_blocks=2)
    # one block (K >= 2 but T = 1) is no remat: the carry is returned
    ys, carry = _lstm_scan(acts[:1], torch.zeros(1, 3, 4, 3),
                           torch.zeros(1, 3, 3), torch.ones(1, 1, 2, 1),
                           torch.float32, return_carry=True, remat_blocks=2)
    assert ys.shape == (1, 1, 2, 3) and carry[0].shape == (1, 2, 3)


def _saved_bytes(backend, remat_blocks):
    """Bytes of the distinct storages autograd keeps for backward (the
    checkpoints' inputs included) after one BLSTM layer's forward at
    T = 512."""
    rng = np.random.RandomState(5)
    Tl, Bl, Pl, Hl = 512, 4, 16, 16
    params = {k: torch.tensor(rng.uniform(-0.5, 0.5, s), dtype=torch.float32,
                              requires_grad=True)
              for k, s in (("W_in", (2, Pl, 4, Hl)), ("W_rec", (2, Hl, 4, Hl)),
                           ("b", (2, 4, Hl)), ("peep", (2, 3, Hl)))}
    x = torch.zeros(Tl, Bl, Pl)
    pt = torch.ones(Tl, Bl, dtype=torch.int8)
    storages = {}

    def pack(t):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        lstm_forward(params, x, pt, 1.0, True, backend=backend,
                     remat_blocks=remat_blocks)
    return sum(storages.values())


@pytest.mark.parametrize("backend", ["scan", "auto"])
def test_remat_reduces_saved_bytes(backend):
    """--remat_blocks exists to shrink what backward holds: K = 8 keeps at
    least 1.5x fewer bytes than K = 0 (tests/test_lstm_parity.py's bound
    on the JAX package's compiled grad)."""
    full, remat = _saved_bytes(backend, 0), _saved_bytes(backend, 8)
    assert full >= 1.5 * remat, (full, remat)


# ------------------------------------------------------------- the net
LAYERS = [
    {"name": "input", "type": "input", "size": 4},
    {"name": "l1", "type": "blstm", "size": 6, "bias": 1.0},
    {"name": "l2", "type": "lstm", "size": 5, "bias": 0.5},
    {"name": "output", "type": "softmax", "size": 7, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": 7},
]


def test_loss_and_count_fused_under_remat_takes_k5(monkeypatch):
    """Network.loss_and_count_fused with remat_blocks=2 routes the tail
    to K5 (not K3 or K4) and matches the JAX package's
    loss_and_count_fused(padded=False) under remat, whose hidden width
    (5, not a 128 multiple) sends it to K5 in interpret mode: the loss,
    the count and every gradient."""
    calls = []
    for name in ("plain_fwd_reference", "softmax_ce_fwd_reference",
                 "softmax_ce_wide_fwd_reference"):
        f = getattr(sc, name)
        monkeypatch.setattr(sc, name, functools.partial(
            lambda f, n, *a, **k: calls.append(n) or f(*a, **k), f, name))
    rng = np.random.RandomState(9)
    Tn, Bn = 9, 3
    x = rng.randn(Tn, Bn, 4).astype(np.float32)
    pt = np.asarray(pattypes_from_lengths([9, 5, 2], Tn, Bn))
    tc = rng.randint(0, 7, (Tn, Bn)).astype(np.int32)
    tc[pt == 0] = -1

    jnet = JaxNetwork(LAYERS, backend="scan")
    jnet.init_params(3)
    jnet.remat_blocks = 2
    (e_j, c_j), g_j = jax.value_and_grad(
        lambda p: jnet.loss_and_count_fused(
            p, jnp.asarray(x), jnp.asarray(tc), jnp.asarray(pt),
            padded=False, interpret=True), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jnet.params))

    net = Network(LAYERS)
    net.init_params(3)
    net.remat_blocks = 2
    params = net.device_params("cpu")
    leaves = [params[n][k] for n in sorted(params) for k in sorted(params[n])]
    for v in leaves:
        v.requires_grad_(True)
    err, cnt = net.loss_and_count_fused(params, torch.tensor(x),
                                        torch.tensor(tc), torch.tensor(pt))
    grads = torch.autograd.grad(err, leaves)
    assert calls == ["plain_fwd_reference"]
    assert err.item() == pytest.approx(float(e_j), rel=1e-6)
    assert cnt.item() == int(c_j)
    want = [g_j[n][k] for n in sorted(params) for k in sorted(params[n])]
    for got, w in zip(grads, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * scale)
    # without remat the same net takes K3
    net.remat_blocks = 0
    net.loss_and_count_fused(params, torch.tensor(x), torch.tensor(tc),
                             torch.tensor(pt))
    assert calls[-1] == "softmax_ce_fwd_reference"


# ------------------------------------------------------------- the CLI
def _epoch_rows(out):
    """The epoch table's error columns, as floats (durations and rates
    dropped)."""
    rows = []
    for ln in out.splitlines():
        cells = ln.split("|")
        if len(cells) > 4 and cells[0].strip().isdigit():
            rows.append([float(v.rstrip("%")) for c in cells[2:4]
                         for v in c.split()])
    return rows


def _run(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(args) == 0
    return buf.getvalue()


def test_cli_train_remat_matches_jax(tmp_path):
    """cli --train true --remat_blocks 2 on the CPU against the JAX CLI
    with the same flag: the epoch table's errors and the trained weights
    (the bounds of test_torch_cli.test_train_matches_jax)."""
    from lstm_rnn_tpu import io_currennt as jax_ioc
    outs = {}
    rows = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        outs[name] = str(tmp_path / f"{name}.jsn")
        rows[name] = _epoch_rows(_run(main, _train_args(tmp_path, outs[name])
                                      + ["--remat_blocks", "2"]))
    assert len(rows["port"]) == len(rows["jax"]) == 2
    # one unit of the last printed digit (2 decimals of %, 3 of error)
    np.testing.assert_allclose(rows["port"], rows["jax"], rtol=0,
                               atol=1.001e-2)
    want = jax_ioc.load_network_json(outs["jax"])["weights"]
    got = jax_ioc.load_network_json(outs["port"])["weights"]
    for name, layer in want.items():
        for part, values in layer.items():
            np.testing.assert_allclose(got[name][part], values, rtol=0,
                                       atol=1e-5, err_msg=f"{name}/{part}")


def test_cli_forward_ignores_remat(tmp_path):
    """Forward mode with --remat_blocks equals forward mode without, as
    in the JAX CLI (a training-only memory lever)."""
    common = _setup(tmp_path) + ["--device", "cpu"]
    for extra, out in (([], "plain.csv"), (["--remat_blocks", "3"],
                                          "remat.csv")):
        assert cli.main(common + extra + ["--ff_output_file",
                                          str(tmp_path / out)]) == 0
    assert ((tmp_path / "plain.csv").read_text()
            == (tmp_path / "remat.csv").read_text())
