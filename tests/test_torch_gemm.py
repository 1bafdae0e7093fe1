"""The plain twin of the port's matrix-product engine (lstm_rnn_tpu_torch/
ops/gemm.py, the function of csrc/gemm.cuh's GEMM) against a float64
NumPy oracle written from the View contract, at odd widths (117, 125,
183): every product the main path runs (each transpose pair), dW_rec's
row shift of +-B with its zero edge, dx's two groups with each plane
rounded to bf16, split-K summed in a fixed order, and the projection's
bias epilogue.

Tolerances: the twin computes in f32 (bf16 operands are exact in f32)
against float64, so f32 sum-order noise, relative to each output's
largest entry (1e-5); where the twin rounds to bf16 (dx's planes, the
tail's dh in bf16 mode) the oracle rounds the same float64 values, and a
value within f32 noise of a rounding boundary may round the other way,
one bf16 ulp (2^-8 of the element; the bound 2^-7 of the largest).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lstm_rnn_tpu_torch.ops import gemm as ge
from lstm_rnn_tpu_torch.ops.gemm import View

REL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}
ROUNDED_REL = 2.0 ** -7
GEMM_CUH = (Path(__file__).resolve().parents[1] / "lstm_rnn_tpu_torch"
            / "csrc" / "gemm.cuh")


def np_dense(flat, v, nrows, ncols):
    """The oracle's view: element by element, float64."""
    out = np.zeros((nrows, ncols))
    for r in range(nrows):
        rr = r + v.shift
        if not 0 <= rr < v.rows:
            continue
        for c in range(min(ncols, v.cols)):
            out[r, c] = flat[v.offset + rr * v.ld + c]
    return out


def bf16_round(a):
    return torch.tensor(a, dtype=torch.float64).to(torch.bfloat16).double() \
        .numpy()


def oracle(use, a, b, M, N, K, outputs=1, ngroups=1, bias=None,
           bias_mult=1.0, bf16=False):
    ta, tb = ge.TRANSPOSE[use]
    flat = {id(v): v.t.double().reshape(-1).numpy() for v in (*a, *b)}

    def A(v):
        return np_dense(flat[id(v)], v, K, M).T if ta else \
            np_dense(flat[id(v)], v, M, K)

    def B(v):
        return np_dense(flat[id(v)], v, N, K).T if tb else \
            np_dense(flat[id(v)], v, K, N)
    if use == "dx":
        planes = [A(a[g]) @ B(b[g]) for g in range(ngroups)]
        return sum(bf16_round(p) if bf16 else p for p in planes)
    outs = []
    for d in range(outputs):
        o = A(a[d]) @ B(b[d])
        if use == "proj":
            o = o + bias_mult * bias[d].double().numpy()
        outs.append(o)
    if use == "tail_dh":
        return bf16_round(outs[0]) if bf16 else outs[0]
    return np.stack(outs)


def rel(got, want):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    return np.abs(got - want).max() / max(1e-30, np.abs(want).max())


def operand(rng, shape, dtype):
    return torch.tensor(rng.randn(*shape), dtype=torch.float32).to(dtype)


def case(use, dtype, seed=0):
    """A small instance of each main-path product at odd widths, laid out
    as its caller lays it out: (a views, b views, M, N, K, kwargs)."""
    rng = np.random.RandomState(seed)
    T, B, P, H, S = 7, 5, 117, 125, 183
    R, G = T * B, 4 * H
    if use == "proj":  # x [R, P] . w_in[d] [P, G] + bias_mult * b[d]
        x = operand(rng, (R, P), dtype)
        w = operand(rng, (2, P, G), dtype)
        return ([View(x, 0, P, R, P)] * 2,
                [View(w, d * P * G, G, P, G) for d in range(2)], R, G, P,
                dict(outputs=2, bias=torch.tensor(rng.randn(2, G),
                                                  dtype=torch.float32),
                     bias_mult=0.5))
    if use in ("dW_in", "dW_rec"):
        da = operand(rng, (2, R, G), dtype)
        bv = [View(da, d * R * G, G, R, G) for d in range(2)]
        if use == "dW_in":  # x^T . da[d]
            x = operand(rng, (R, P), dtype)
            return [View(x, 0, P, R, P)] * 2, bv, P, G, R, dict(outputs=2)
        h = operand(rng, (R, 2 * H), dtype)  # h_prev^T . da[d]
        return ([View(h, 0, 2 * H, R, H, -B), View(h, H, 2 * H, R, H, B)],
                bv, H, G, R, dict(outputs=2))
    if use == "dx":  # sum_d round(da[d] . W_in[d]^T)
        da = operand(rng, (2, R, G), dtype)
        w = operand(rng, (2, P, G), dtype)
        return ([View(da, d * R * G, G, R, G) for d in range(2)],
                [View(w, d * P * G, G, P, G) for d in range(2)], R, P, G,
                dict(ngroups=2))
    dz = operand(rng, (R, S), dtype)
    if use == "tail_dh":  # dz . W^T
        w = operand(rng, (P, S), dtype)
        return [View(dz, 0, S, R, S)], [View(w, 0, S, P, S)], R, P, S, {}
    h = operand(rng, (R, P), dtype)  # tail_dW: h^T . dz
    return [View(h, 0, P, R, P)], [View(dz, 0, S, R, S)], P, S, R, {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use", ge.USES)
def test_twin_matches_float64_oracle(use, dtype):
    a, b, M, N, K, kw = case(use, dtype)
    got = ge.gemm(use, a, b, M, N, K, compute_dtype=dtype, **kw)
    want = oracle(use, a, b, M, N, K, bf16=dtype == torch.bfloat16,
                  **{k: v for k, v in kw.items() if k != "nsplit"})
    rounded = dtype == torch.bfloat16 and use in ("dx", "tail_dh")
    assert tuple(got.shape) == want.shape
    assert got.dtype == (dtype if use == "tail_dh" else torch.float32)
    assert rel(got, want) <= (ROUNDED_REL if rounded else REL[dtype])


@pytest.mark.parametrize("shift", [-5, 5])
def test_shifted_rows_read_zero_at_the_edge(shift):
    """dW_rec's h_prev: rows shifted by -B (ascending scan) or +B
    (descending) read zero for the B rows past either end."""
    rng = np.random.RandomState(1)
    R, H, G = 35, 125, 12
    h = operand(rng, (R, 2 * H), torch.float32)
    da = operand(rng, (R, G), torch.float32)
    a = [View(h, H, 2 * H, R, H, shift)]
    b = [View(da, 0, G, R, G)]
    got = ge.gemm("dW_rec", a, b, H, G, R)[0]
    hh = h[:, H:].double().numpy()
    prev = np.zeros_like(hh)
    if shift < 0:
        prev[-shift:] = hh[:shift]
    else:
        prev[:-shift] = hh[shift:]
    want = prev.T @ da.double().numpy()
    assert rel(got, want) <= 1e-5
    # the control: the other direction's shift gives another product
    other = ge.gemm("dW_rec", [a[0]._replace(shift=-shift)], b, H, G, R)[0]
    assert rel(other, want) > 1e-2


def test_dx_rounds_each_plane_before_the_sum():
    a, b, M, N, K, kw = case("dx", torch.bfloat16, seed=2)
    got = ge.gemm("dx", a, b, M, N, K, compute_dtype=torch.bfloat16, **kw)
    want = oracle("dx", a, b, M, N, K, ngroups=2, bf16=True)
    unrounded = oracle("dx", a, b, M, N, K, ngroups=2, bf16=False)
    assert rel(got, want) <= ROUNDED_REL
    # the rounding is there: the unrounded sum is further off than noise
    assert np.abs(got.double().numpy() - unrounded).max() > \
        np.abs(got.double().numpy() - want).max()
    # the f32 mode rounds nothing
    a32 = [v._replace(t=v.t.float()) for v in a]
    b32 = [v._replace(t=v.t.float()) for v in b]
    got32 = ge.gemm("dx", a32, b32, M, N, K, ngroups=2)
    assert rel(got32, unrounded) <= 1e-5


@pytest.mark.parametrize("K, nsplit", [(1000, 5), (1000, 16), (130, 3),
                                       (25_000, 32)])
def test_split_k_in_fixed_order(K, nsplit):
    """Splits start on 64-row boundaries and cover [0, K) once, trailing
    splits may be empty; the result is the partials added in split
    order, bit for bit, and the float64 product within f32 noise."""
    ranges = ge.split_ranges(K, nsplit)
    assert len(ranges) == nsplit and ranges[0][0] == 0
    assert ranges[-1][1] == K
    assert all(k1 == k0n for (_, k1), (k0n, _) in zip(ranges, ranges[1:]))
    assert all(k0 % ge.SPLIT_ALIGN == 0 or k0 == K for k0, _ in ranges)
    rng = np.random.RandomState(3)
    P, S = 13, 9
    h = operand(rng, (K, P), torch.float32)
    dz = operand(rng, (K, S), torch.float32)
    a, b = [View(h, 0, P, K, P)], [View(dz, 0, S, K, S)]
    got = ge.gemm("tail_dW", a, b, P, S, K, nsplit=nsplit)[0]
    acc = torch.zeros(P, S)
    for k0, k1 in ranges:
        acc = acc + h[k0:k1].T @ dz[k0:k1]
    assert torch.equal(got, acc)
    assert rel(got, h.double().numpy().T @ dz.double().numpy()) <= 1e-5
    # the control: a dropped split is caught
    k0, k1 = ranges[0]
    dropped = acc - h[k0:k1].T @ dz[k0:k1]
    assert rel(dropped, h.double().numpy().T @ dz.double().numpy()) > 1e-3


def test_bias_epilogue_rounds_the_bias_product_alone():
    a, b, M, N, K, kw = case("proj", torch.float32, seed=4)
    got = ge.gemm("proj", a, b, M, N, K, **kw)
    prod = torch.stack([a[d].t @ b[d].t.reshape(2, K, N)[d]
                        for d in range(2)])
    # the bias product in f32, then added: as the reference adds
    # bias_mult * bias to the finished matmul
    want = prod + (kw["bias_mult"] * kw["bias"])[:, None, :]
    assert rel(got, want.double().numpy()) <= 1e-6
    assert rel(got, oracle("proj", a, b, M, N, K, outputs=2, bias=kw["bias"],
                           bias_mult=0.5)) <= 1e-5


def test_splits_follow_the_engine():
    """ops/gemm.py's split rule is gemm.cuh's gemm_splits."""
    src = GEMM_CUH.read_text()
    per = int(re.search(r"int s = K / (\d+);", src).group(1))
    cap = int(re.search(r"s > (\d+) \? \1 : s", src).group(1))
    for K in (1, 191, 192, 6_250, 25_000, 40_000, 10**6):
        assert ge.splits(K) == min(cap, max(1, K // per))


def test_launch_counts_by_use():
    before = {u: c.launches for u, c in ge.LAUNCHES.items()}
    ge.count_launches("proj", "dx", "dx")
    after = {u: c.launches for u, c in ge.LAUNCHES.items()}
    assert {u: after[u] - before[u] for u in ge.USES} == dict(
        proj=1, dW_in=0, dW_rec=0, dx=2, tail_dh=0, tail_dW=0)
    # the CPU twins launch nothing
    a, b, M, N, K, kw = case("dW_in", torch.float32)
    ge.gemm("dW_in", a, b, M, N, K, **kw)
    assert {u: c.launches for u, c in ge.LAUNCHES.items()} == after


def test_refuses_what_the_engine_does_not_take():
    a, b, M, N, K, _ = case("tail_dh", torch.float32)
    with pytest.raises(ValueError):
        ge.gemm("tail_dh", a, b, M, N, K, nsplit=2)  # only dW splits
    with pytest.raises(ValueError):
        ge.gemm("tail_dW", a, b, M, N, K, ngroups=2)  # only dx has groups
    with pytest.raises(ValueError):
        ge.gemm("matmul", a, b, M, N, K)
