"""The port's wide classification tail (K4, ops/softmax_ce.py) against the
JAX package's softmax_ce_wide_fused with its Pallas kernels in interpret
mode, on the same numpy inputs made from a seed, through jax.vjp with a
loss cotangent G != 1; and the route between the two tails.

On the CPU the port runs the twins of its two wide kernels. The JAX tail
wants P % 128 == 0 and S padded to wide_plan's Sp_w, so the JAX side gets
h and W zero-padded (zero h columns and W rows add nothing; padded logit
columns are masked by construction); the port takes the exact widths. The
Hopper kernels are held against the twins on the card
(tests/test_torch_kernels_cuda.py).
"""

import functools
import re
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu.ops.softmax_ce import _wide_fwd_impl, wide_plan
from lstm_rnn_tpu.ops.softmax_ce import softmax_ce_wide_fused as jax_tail
from lstm_rnn_tpu_torch.ops import softmax_ce as sc
from lstm_rnn_tpu_torch.ops.softmax_ce import (H100_SMEM_OPTIN,
                                               proj_tail_fits,
                                               softmax_ce_wide_bwd,
                                               softmax_ce_wide_fused,
                                               softmax_ce_wide_fwd,
                                               tail_smem_optin)

N, P, PP, S = 512, 100, 128, 1500
# a layer's bias_mult (the LVCSR recipe's softmax: 1.0), and G the loss
# cotangent
BIAS_MULTS, G = (0.8, 1.0), 0.37
DUMMY = (5, 17, 40, 300)  # rows with target -1
DTYPES = ["float32", "bfloat16"]
CSRC = Path(__file__).resolve().parents[1] / "lstm_rnn_tpu_torch" / "csrc"


def _inputs():
    rng = np.random.RandomState(S)
    h = (0.5 * rng.randn(N, P)).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, (P, S)).astype(np.float32)
    b = rng.uniform(-0.3, 0.3, S).astype(np.float32)
    tc = rng.randint(0, S, N).astype(np.int32)
    tc[list(DUMMY)] = -1
    # rows 10 and 11 see only the bias, whose maximum is tied at classes 1
    # and 3: the first argmax (1) counts for row 11, not for row 10
    h[10:12] = 0.0
    b[1] = b[3] = b.max() + 1.0
    tc[10], tc[11] = 3, 1
    return h, w, b, tc


@functools.lru_cache(maxsize=None)
def _jax(dtype, bias_mult):
    h, w, b, tc = _inputs()
    dt = jnp.dtype(dtype)
    spw = wide_plan(N, PP, S, dt)[0]
    hp = jnp.asarray(np.pad(h, ((0, 0), (0, PP - P))))
    wp = jnp.asarray(np.pad(w, ((0, PP - P), (0, spw - S))))
    bp = jnp.asarray(np.pad(b, (0, spw - S)))
    t2 = jnp.asarray(tc[:, None])
    f = functools.partial(jax_tail, targets=t2, S=S, bias_mult=bias_mult,
                          interpret=True, compute_dtype=dt)
    loss, vjp = jax.vjp(lambda *a: f(*a)[0], hp, wp, bp)
    cnt = f(hp, wp, bp)[1]
    dh, dw, db = vjp(jnp.asarray(G, jnp.float32))
    (_, _), (a, _, _, _, off, ssum, pt) = _wide_fwd_impl(
        hp, wp, bp, t2, S, bias_mult, True, dt)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(loss=float(loss), cnt=int(cnt), a=f32(a)[:, :S],
                off=f32(off)[:, 0], ssum=f32(ssum)[:, 0], pt=f32(pt)[:, 0],
                dh=f32(dh)[:, :P], dW=f32(dw)[:P, :S], db=f32(db)[:S])


def _tolerance(dtype, ref):
    if dtype == "float32":
        # true f32 on both sides, sums in another order
        return 1e-5 * float(np.abs(ref).max())
    # the logits and dz are stored in bf16: a value rounded to the other
    # side of a bf16 boundary moves what it enters by up to one bf16 ulp
    # (2^-8) of the largest entry
    return 2.0 ** -8 * float(np.abs(ref).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias_mult", BIAS_MULTS)
def test_wide_forward_matches_jax(bias_mult, dtype):
    want = _jax(dtype, bias_mult)
    h, w, b, tc = (torch.tensor(x) for x in _inputs())
    dt = getattr(torch, dtype)
    loss, cnt, a, off, ssum, pt = softmax_ce_wide_fwd(h, w, b, tc, bias_mult,
                                                      dt)
    assert loss.dtype == torch.float32 and cnt.dtype == torch.int32
    assert a.dtype == dt and a.shape == (N, S)
    # loss over 508 rows: f32 sum order (bf16: p in f32 from the same a)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
    assert int(cnt) == want["cnt"]
    got = dict(a=a.float(), off=off, ssum=ssum, pt=pt)
    for name, x in got.items():
        assert x.shape[0] == N, name
        np.testing.assert_allclose(x.numpy(), want[name], rtol=0,
                                   atol=_tolerance(dtype, want[name]),
                                   err_msg=name)
    assert not pt[list(DUMMY)].any()  # dummy rows: no target probability
    # the tie row: classes 1 and 3 hold the same logit, so the first
    # argmax (class 1) is row 11's target and not row 10's
    assert a[10, 1] == a[10, 3] == a[10].max()
    # without stats the forward keeps none, and gives the same loss
    loss0, cnt0, _, *stats = softmax_ce_wide_fwd(h, w, b, tc, bias_mult, dt,
                                                 want_stats=False)
    assert stats == [None] * 3
    assert float(loss0) == float(loss) and int(cnt0) == int(cnt)
    with torch.no_grad():
        loss1, cnt1 = softmax_ce_wide_fused(h, w, b, tc, S, bias_mult, dt)
    assert float(loss1) == float(loss) and int(cnt1) == int(cnt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias_mult", BIAS_MULTS)
def test_wide_gradients_match_jax(bias_mult, dtype):
    want = _jax(dtype, bias_mult)
    h, w, b, tc = _inputs()
    ts = [torch.tensor(x, requires_grad=True) for x in (h, w, b)]
    loss, cnt = softmax_ce_wide_fused(*ts, torch.tensor(tc), S, bias_mult,
                                      getattr(torch, dtype))
    np.testing.assert_allclose(float(loss.detach()), want["loss"], rtol=1e-5)
    dh, dw, db = torch.autograd.grad(loss, ts, torch.tensor(G))
    assert dh.dtype == dw.dtype == db.dtype == torch.float32
    for name, got in (("dh", dh), ("dW", dw), ("db", db)):
        assert got.shape == want[name].shape, name
        np.testing.assert_allclose(got.numpy(), want[name], rtol=0,
                                   atol=_tolerance(dtype, want[name]),
                                   err_msg=name)
    assert not dh[list(DUMMY)].any()  # dummy rows get no gradient


def test_twins_count_no_launch():
    h, w, b, tc = (torch.tensor(x) for x in _inputs())
    before = (softmax_ce_wide_fwd.launches, softmax_ce_wide_bwd.launches)
    _, _, a, off, ssum, pt = softmax_ce_wide_fwd(h, w, b, tc)
    softmax_ce_wide_bwd(a, h, w, tc, off, ssum, pt, torch.tensor(1.0))
    assert (softmax_ce_wide_fwd.launches,
            softmax_ce_wide_bwd.launches) == before


@pytest.mark.parametrize("S_, fits", [(183, True), (704, True),
                                      (705, False), (10112, False)])
def test_route_at_the_h100_budget(S_, fits):
    """K3's forward holds, beside its stage ring, a [64, S] f32 logits
    block (S rounded up to 8) once S > 256: 704 classes fit an H100's
    232,448 bytes, 705 do not. The CPU takes the H100's budget."""
    assert tail_smem_optin("cpu") == H100_SMEM_OPTIN == 232_448
    assert proj_tail_fits(S_, H100_SMEM_OPTIN) is fits


def _source_ints(path, names):
    src = path.read_text()
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
            for n in names}


@pytest.mark.parametrize("bf16", [True, False])
def test_route_footprint_follows_the_kernel_source(bf16):
    """proj_tail_fits states K3's real footprint: its constants are the
    kernel's (csrc/softmax_ce.cu, csrc/gemm.cuh), and its bytes at every
    S are those of ce_smem_bytes plus the static per-row arrays (three
    warpgroups' worth), written
    here from the source's constants."""
    c = _source_ints(CSRC / "softmax_ce.cu",
                     ("kCeRows", "kCeChunk", "kCeMaxChunks", "kCeWideChunks"))
    g = _source_ints(CSRC / "gemm.cuh", ("kSimtBK", "kSimtPad", "kWgBK"))
    src = (CSRC / "softmax_ce.cu").read_text()
    assert "constexpr int kCeTile = kCeRows * kWgBK * 2;" in src
    assert "constexpr int kCeStaticBytes = 6 * kCeRows * 4;" in src
    assert "return (S + 7) / 8 * 8;" in src  # the logits block's pitch
    assert (sc._PROJ_ROWS, sc._PROJ_CHUNK, sc._PROJ_MAX_CHUNKS,
            sc._PROJ_WIDE_CHUNKS) == tuple(c.values())
    assert (sc._SIMT_BK, sc._SIMT_PAD) == (g["kSimtBK"], g["kSimtPad"])
    tile = c["kCeRows"] * g["kWgBK"] * 2

    def ring(nch):
        if bf16:
            return 2 * (1 + nch) * tile + 1024
        return 2 * g["kSimtBK"] * (c["kCeRows"] + 2 * g["kSimtPad"]
                                   + nch * c["kCeChunk"]) * 4

    one_pass = c["kCeMaxChunks"] * c["kCeChunk"]
    for S_ in range(1, 1200):
        logits = c["kCeRows"] * ((S_ + 7) // 8 * 8) * 4
        if S_ > one_pass:
            want = ring(c["kCeWideChunks"]) + logits
        elif bf16:
            want = ring(-(-S_ // c["kCeChunk"]))
        else:
            want = max(ring(-(-S_ // c["kCeChunk"])), logits)
        assert sc.proj_smem_bytes(S_, bf16) == want + 6 * c["kCeRows"] * 4


@pytest.mark.parametrize("bf16", [True, False])
def test_k4b_tiles_follow_the_kernel_source(bf16):
    """wide_bwd_plan states K4b's real launch: its tile constants are the
    kernel's (csrc/softmax_ce_wide.cu), a block's shared memory (the
    source's Bwd<T>::kSmem, written here from its constants) fits an
    H100's 232,448 bytes at every P, P above one pass of 256 rows of dW
    takes more passes, and a P the kernel does not take raises (the
    network's fused tail routes such a net to K5: wide_tail_fits)."""
    src = (CSRC / "softmax_ce_wide.cu").read_text()
    c = _source_ints(CSRC / "softmax_ce_wide.cu",
                     ("kBwdCols", "kBwdPass", "kBwdStages", "kBwdMaxPasses",
                      "kBwdRowsBf16", "kBwdRowsF32", "kRowFloats"))
    assert (sc._BWD_COLS, sc._BWD_PASS, sc._BWD_MAX_PASSES) == (
        c["kBwdCols"], c["kBwdPass"], c["kBwdMaxPasses"])
    assert sc._BWD_ROWS == {True: c["kBwdRowsBf16"],
                            False: c["kBwdRowsF32"]}
    assert sc._BWD_ROW_FLOATS == c["kRowFloats"]
    assert "constexpr int kRowBytes = kRowFloats * 4;" in src
    for line in ("kZBytes = kRows * kBwdCols * kEs;",
                 "kHBytes = kRows * kBwdPass * kEs;",
                 "kStageBytes = kZBytes + kHBytes + kRows * kRowBytes;",
                 "kSmem = kBwdStages * kStageBytes + 1024;",
                 "kRows = kBf16 ? kBwdRowsBf16 : kBwdRowsF32;"):
        assert f"static constexpr int {line}" in src, line
    rows, es = sc._BWD_ROWS[bf16], 2 if bf16 else 4
    smem = c["kBwdStages"] * (rows * (c["kBwdCols"] + c["kBwdPass"]) * es
                              + rows * c["kRowFloats"] * 4) + 1024
    # one footprint at every P: the passes over P are blocks of their own
    assert smem <= H100_SMEM_OPTIN
    N, S_ = 25_000, 10_112
    for P_, passes in ((7, 1), (250, 1), (256, 1), (300, 2), (512, 2),
                       (1024, 4)):
        plan = sc.wide_bwd_plan(N, P_, S_, bf16)
        assert plan["passes"] == passes
        assert (plan["hp_rows"], plan["hp_cols"]) == (
            -(-N // rows) * rows, passes * c["kBwdPass"])
    with pytest.raises(ValueError, match="P <= 1024"):
        sc.wide_bwd_plan(N, 1025, S_, bf16)
    assert sc.wide_tail_fits(1024) and not sc.wide_tail_fits(1025)


@pytest.mark.parametrize("N_, S_", [(25_000, 10_112), (70, 1001),
                                    (1000, 2049), (64, 7)])
def test_k4b_splits_fill_the_card_and_none_is_empty(N_, S_):
    """The row splits: at the LVCSR tail 79 column blocks x 5 splits fill
    132 SMs in three waves less one block; at every shape each split gets
    rows (the kernel refuses an empty one) and the splits cover them."""
    for bf16 in (True, False):
        plan = sc.wide_bwd_plan(N_, 250, S_, bf16)
        ns, nt = plan["nsplit"], plan["ntiles"]
        tps = -(-nt // ns)
        assert 1 <= ns <= min(16, nt) and -(-nt // tps) == ns
        assert (ns - 1) * tps < nt <= ns * tps
        if (N_, S_) == (25_000, 10_112):
            assert ns == 5 and nt == (391 if bf16 else 782)


def _rn32(q):
    """q (a Fraction) rounded to the nearest binary32, ties to even, with
    the subnormal floor; as a Fraction."""
    if q == 0:
        return Fraction(0)
    if q < 0:
        return -_rn32(-q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    while Fraction(2) ** e > q:
        e -= 1
    while Fraction(2) ** (e + 1) <= q:
        e += 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    m = q / ulp
    fl = m.numerator // m.denominator
    rem = m - fl
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and fl % 2):
        fl += 1
    return fl * ulp


def test_k3f_division_is_correctly_rounded():
    """K3f's, K4b's and K5f's p = e / sum (csrc/softmax_ce.cu ce_div,
    csrc/softmax_ce_wide.cu's bwd_dz from the row's 1 / sum, and
    csrc/softmax_ce_plain.cu's plain_p from plain_row's): q = e *
    RN(1/s), then one FMA correction from the exact remainder,
    fma(fma(-q, s, e), inv, q), equals the correctly rounded quotient
    e / s for 0 < e <= s with a normal quotient; each FMA rounds once,
    emulated here exactly."""
    src = (CSRC / "softmax_ce.cu").read_text()
    assert "const float q = e * inv;" in src
    assert "fmaf(fmaf(-q, s, e), inv, q)" in src
    assert "inv[hf] = __frcp_rn(sum[hf]);" in src
    wide = (CSRC / "softmax_ce_wide.cu").read_text()
    assert "const float rs = __frcp_rn(sum);" in wide
    assert "const float q = ex * c0[k].z;" in wide
    assert "fmaf(fmaf(-q, c0[k].y, ex), c0[k].z, q)" in wide
    plain = (CSRC / "softmax_ce_plain.cu").read_text()
    assert "r.rs = finite ? __frcp_rn(r.sum) : 0.0f;" in plain
    assert "const float q = e * r.rs;" in plain
    assert "fmaf(fmaf(-q, r.sum, e), r.rs, q)" in plain
    rng = np.random.RandomState(8)
    f32 = lambda x: Fraction(float(np.float32(x)))  # noqa: E731
    for _ in range(4000):
        s = f32(rng.uniform(1.0, 5e4) * 2.0 ** rng.randint(-20, 21))
        e = f32(float(s) * rng.uniform() ** rng.choice([1, 3, 10]))
        if e == 0:
            continue
        inv = _rn32(1 / s)
        q = _rn32(e * inv)
        got = _rn32(q + _rn32(e - q * s) * inv)
        assert got == _rn32(e / s), (float(e), float(s))
