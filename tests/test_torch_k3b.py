"""K3b, the TIMIT tail's backward (ops/softmax_ce.py `softmax_ce_proj_bwd`,
csrc/softmax_ce.cu's pb_* kernels), on the CPU.

dz never leaves the card's chip, so its arithmetic is held here through a
mirror of the kernels' layout written in torch: the rows' constants as
pb_prep_kernel computes them, p read from its flat storage through the
16-byte chunks that hold each row's columns (pb_fill_seg) from each row's
shift (pb_shift), dz formed in 8-column chunks with zero past S (pb_dz8), W
packed zero-padded to [pp, sp], dh over the padded columns, and dW and db
as the dW kernel's column blocks, passes over P and row splits lay them
out, their partials summed in split order. At every width the mirror's dz
is the twin's bit for bit, and its dh, dW and db are the twin's to f32
sum-order noise; the twin itself is held against the JAX package's
interpret-mode kernels at the wider widths. The tile constants are read
from the kernel source. The Hopper kernels are held against the twin on
the card (tests/test_torch_kernels_cuda.py).
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu.ops.softmax_ce import softmax_ce_proj_fused as jax_tail
from lstm_rnn_tpu_torch.ops import softmax_ce as sc
from lstm_rnn_tpu_torch.ops.activations import REAL_MIN

CSRC = Path(__file__).resolve().parents[1] / "lstm_rnn_tpu_torch" / "csrc"
# S at each body's edges: one 64-column chunk, three (the TIMIT tail's
# 183, on the resident dh), 256 (two dW column blocks, the streamed dh),
# above it, and the route's limit of 704; P one pass of dW and two
WIDTHS = [(S, P) for S in (5, 183, 256, 300, 704) for P in (100, 250)]
N = 197  # ends inside a row tile of both modes (64 and 32 rows)


def _source_ints(names):
    src = (CSRC / "softmax_ce.cu").read_text()
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
            for n in names}


def test_k3b_tiles_follow_the_kernel_source():
    """proj_bwd_plan's constants are the kernels' (csrc/softmax_ce.cu),
    and each kernel's shared memory, written here from them as the
    source's PbDh, PbRes and PbDw compute it, fits an H100's 232,448
    bytes at every width the route sends (S <= 704, any P)."""
    c = _source_ints(("kPbThreads", "kPbRows", "kPbDhCols", "kPbDhKBf16",
                      "kPbDhKF32", "kPbResColsBf16", "kPbResColsF32",
                      "kPbResMax", "kPbDwRows",
                      "kPbDwCols", "kPbDwTileBf16", "kPbDwTileF32",
                      "kPbDwStages", "kPbDzThreads"))
    assert (sc._PB_ROWS, sc._PB_DH_COLS) == (c["kPbRows"], c["kPbDhCols"])
    assert sc._PB_DH_K == {True: c["kPbDhKBf16"], False: c["kPbDhKF32"]}
    assert sc._PB_RES_COLS == {True: c["kPbResColsBf16"],
                               False: c["kPbResColsF32"]}
    assert sc._PB_RES_MAX == c["kPbResMax"]
    assert (sc._PB_DW_ROWS, sc._PB_DW_COLS) == (c["kPbDwRows"],
                                                c["kPbDwCols"])
    assert sc._PB_DW_TILE == {True: c["kPbDwTileBf16"],
                              False: c["kPbDwTileF32"]}
    # the dz formers: 24 chunks of 8 columns x 8 row groups
    assert c["kPbDzThreads"] == c["kPbDwCols"] // 8 * 8 <= c["kPbThreads"]
    src = (CSRC / "softmax_ce.cu").read_text()
    for line in ("kSegs = kK * kEs / 16 + 1;",
                 "kStage = kWBytes + kSegBytes + kZBytes;",
                 "kSmem = 2 * kStage + 1024;",
                 "kSegs = kPbDwCols * kEs / 16 + 1;",
                 "kSmem = kPbDwStages * kStage + 2 * kZBytes + 1024;"):
        assert f"static constexpr int {line}" in src, line
    opt = sc.H100_SMEM_OPTIN
    for bf16 in (True, False):
        es = 2 if bf16 else 4
        k = sc._PB_DH_K[bf16]
        segs = k * es // 16 + 1
        dh = 2 * (c["kPbDhCols"] * k * es + c["kPbRows"] * segs * 16
                  + c["kPbRows"] * k * es) + 1024 + c["kPbRows"] * 16
        rows = sc._PB_DW_TILE[bf16]
        stage = -(-(rows * c["kPbDwRows"] * es
                    + rows * (c["kPbDwCols"] * es // 16 + 1) * 16
                    + rows * 16) // 1024) * 1024
        dw = c["kPbDwStages"] * stage + 2 * rows * c["kPbDwCols"] * es + 1024
        assert dh <= opt and dw <= opt, (bf16, dh, dw)
        # dW's staged partial tile fits its ring
        assert c["kPbDwRows"] * (c["kPbDwCols"] + 4) * 4 <= (
            c["kPbDwStages"] * stage)
        # the resident dh at the widest S it takes (sp: S rounded as W)
        cols = sc._PB_RES_COLS[bf16]
        sp = -(-sc._PB_RES_MAX // k) * k
        z = max(c["kPbRows"] * sp * es, c["kPbRows"] * (cols + 16 // es) * es)
        bufs = 2 if bf16 else 1
        res = (cols * sp * es + bufs * (c["kPbRows"] * (sp * es // 16 + 1)
                                        * 16 + c["kPbRows"] * 16) + z + 1024)
        assert res <= opt, (bf16, res)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("N_", [25_000, 1037, 70, 1])
@pytest.mark.parametrize("S, P", WIDTHS)
def test_k3b_plan_fills_the_card_and_no_split_is_empty(S, P, N_, bf16):
    plan = sc.proj_bwd_plan(N_, P, S, bf16)
    ntiles, tps, ns = plan["ntiles"], plan["tps"], plan["nsplit"]
    assert ntiles == -(-N_ // plan["rows"])
    assert (ns - 1) * tps < ntiles <= ns * tps  # every split has rows
    blocks = plan["cols"] * plan["passes"] * ns
    assert blocks <= sc.H100_SMS or ns == 1
    if (N_, S, P) == (25_000, 183, 250):
        assert blocks == sc.H100_SMS  # the main path: one block an SM
    assert plan["pp"] % sc._PB_DH_COLS == 0 and plan["pp"] >= P
    assert plan["sp"] % sc._PB_DH_K[bf16] == 0 and plan["sp"] >= S
    assert plan["dh_resident"] is (S <= sc._PB_RES_MAX)


def _inputs(S, P, seed):
    rng = np.random.RandomState(seed)
    h = (0.5 * rng.randn(N, P)).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, (P, S)).astype(np.float32)
    b = rng.uniform(-0.3, 0.3, S).astype(np.float32)
    tc = rng.randint(0, S, N).astype(np.int32)
    tc[::7] = -1
    # a row whose target probability underflows to 0 (pt = 0 on a real
    # row: inv = -1 / REAL_MIN)
    h[3] = 0.0
    b[:] = 0.0
    b[0] = 200.0
    tc[3] = 1
    return h, w, b, tc


def _mirror(p, h, W, tc, g, bias_mult, bf16):
    """(dz, dh, dW, db) as the kernels compute them, in f32 torch ops."""
    sd = torch.bfloat16 if bf16 else torch.float32
    es = 2 if bf16 else 4
    Nn, S = p.shape
    P = W.shape[0]
    plan = sc.proj_bwd_plan(Nn, P, S, bf16)
    # pb_prep_kernel: the rows' constants, once a row
    t = tc.long()
    pt = torch.where(t >= 0,
                     p.float().gather(1, t.clamp_min(0)[:, None])[:, 0],
                     torch.zeros(Nn))
    inv = -1.0 / torch.clamp_min(pt, REAL_MIN)
    s = pt * inv
    ko, kt = -s, inv - s
    # p through its 16-byte chunks: row r's segment from column 0 begins
    # pb_shift elements before (r, 0) in the chunk that holds it
    flat = p.reshape(-1)
    per = 16 // es
    segs = plan["sp"] * es // 16 + 1
    pad = torch.zeros(Nn * S + segs * per, dtype=sd)
    pad[:Nn * S] = flat
    cols = torch.arange(plan["sp"])
    dz = torch.zeros(Nn, plan["sp"])
    for r in range(Nn):
        shift = (r * S) % per
        start = r * S - shift
        assert start % per == 0  # an aligned chunk
        seg = pad[start:start + segs * per].float()
        v = seg[shift:shift + plan["sp"]]
        assert torch.equal(v[:S], p[r].float())
        v = torch.where(cols < S, v, torch.zeros(()))  # past S: zero
        k = torch.where(cols == int(tc[r]), kt[r], ko[r])
        dz[r] = (v * k) * g
    dzc = dz.to(sd).float()
    # W packed zero-padded to [pp, sp]: the padding adds exactly nothing
    wp = torch.zeros(plan["pp"], plan["sp"])
    wp[:P, :S] = W.to(sd).float()
    dh = (dzc @ wp[:P].t()).to(sd)
    # dW and db: a block a column block x pass x split, partials summed in
    # split order
    hc = h.to(sd).float()
    L = P * S + S
    part = torch.zeros(plan["nsplit"], L)
    rows = plan["rows"]
    for split in range(plan["nsplit"]):
        r0 = split * plan["tps"] * rows
        r1 = min(Nn, (split + 1) * plan["tps"] * rows)
        for cx in range(plan["cols"]):
            n0 = cx * sc._PB_DW_COLS
            n1 = min(S, n0 + sc._PB_DW_COLS)
            for ps in range(plan["passes"]):
                m0 = ps * sc._PB_DW_ROWS
                m1 = min(P, m0 + sc._PB_DW_ROWS)
                blk = hc[r0:r1, m0:m1].t() @ dzc[r0:r1, n0:n1]
                dw_part = part[split, :P * S].view(P, S)
                dw_part[m0:m1, n0:n1] = blk
            part[split, P * S + n0:P * S + n1] = dz[r0:r1, n0:n1].sum(0)
    out = torch.zeros(L)
    for split in range(plan["nsplit"]):
        out += part[split]
    return (dz[:, :S], dh, out[:P * S].view(P, S),
            bias_mult * out[P * S:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S, P", WIDTHS)
def test_k3b_layout_and_row_constants_through_the_twin(S, P, dtype):
    """The kernels' arithmetic at every width: dz from the rows' constants
    and the segment shifts is the twin's bit for bit (g = 1 and g = 0.37;
    a dummy row, and a real row whose pt underflows to 0, among them),
    the padded columns of dz and W add nothing, and dh, dW and db from
    the dW kernel's blocks and splits are the twin's to f32 sum-order
    noise (dh in bf16 mode: one bf16 ulp)."""
    bf16 = dtype == "bfloat16"
    sd = torch.bfloat16 if bf16 else torch.float32
    h, w, b, tc = (torch.tensor(x) for x in _inputs(S, P, S + P))
    _, _, p = sc.softmax_ce_proj_fwd(h, w, b, tc, 0.8, sd)
    assert p[3, 1] == 0  # the underflowing row
    for gv in (1.0, 0.37):
        g = torch.tensor(gv)
        dz, dh, dw, db = _mirror(p, h, w, tc, g, 0.8, bf16)
        want = sc.softmax_ce_bwd_reference(p, h, w, tc, g, 0.8, sd)
        assert torch.equal(dz.view(torch.int32),
                           sc.plain_dz_reference(p, tc, g).view(torch.int32))
        assert not dz[tc == -1].any()
        tol = {"dh": 2.0 ** -7 if bf16 else 1e-5, "dW": 1e-5, "db": 1e-5}
        for name, got, ref in zip(("dh", "dW", "db"), (dh, dw, db), want):
            assert got.dtype == ref.dtype and got.shape == ref.shape, name
            err = ((got.float() - ref.float()).abs().max()
                   / ref.float().abs().max().clamp_min(1e-30)).item()
            assert err <= tol[name], (name, err)


def test_twin_dz_is_the_row_constant_order():
    """The twin's dz, p (onehot inv - s) valid g, equals (p k) g with k =
    inv - s at the target and -s elsewhere, bit for bit at any g, on real
    rows, dummy rows (+0 everywhere) and a row whose pt is 0."""
    h, w, b, tc = (torch.tensor(x) for x in _inputs(183, 100, 1))
    _, _, p = sc.softmax_ce_proj_fwd(h, w, b, tc, 1.0)
    for gv in (1.0, 0.37, -2.5):
        g = torch.tensor(gv)
        want = sc.plain_dz_reference(p, tc, g)
        t = tc.long()
        pt = torch.where(t >= 0, p.gather(1, t.clamp_min(0)[:, None])[:, 0],
                         torch.zeros(N))
        inv = -1.0 / torch.clamp_min(pt, REAL_MIN)
        s = pt * inv
        onehot = torch.arange(183)[None, :] == t[:, None]
        k = torch.where(onehot, (inv - s)[:, None], (-s)[:, None])
        got = (p * k) * g
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


NJ, PJ = 64, 250


@functools.lru_cache(maxsize=None)
def _jax(S, dtype):
    rng = np.random.RandomState(S)
    h = (0.5 * rng.randn(NJ, PJ)).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, (PJ, S)).astype(np.float32)
    b = rng.uniform(-0.3, 0.3, S).astype(np.float32)
    tc = rng.randint(0, S, NJ).astype(np.int32)
    tc[::9] = -1
    sp, pp = -(-S // 128) * 128, 256
    hp = np.pad(h, ((0, 0), (0, pp - PJ)))
    wp = np.pad(w, ((0, pp - PJ), (0, sp - S)))
    bp = np.pad(b, (0, sp - S))
    f = functools.partial(jax_tail, targets=jnp.asarray(tc[:, None]), S=S,
                          bias_mult=0.8, interpret=True,
                          compute_dtype=jnp.dtype(dtype))
    _, vjp = jax.vjp(lambda *a: f(*a)[0], *map(jnp.asarray, (hp, wp, bp)))
    dh, dw, db = vjp(jnp.asarray(0.37, jnp.float32))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (h, w, b, tc), (f32(dh)[:, :PJ], f32(dw)[:PJ, :S], f32(db)[:S])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [256, 300, 704])
def test_k3b_twin_matches_jax_at_wide_widths(S, dtype):
    """The port's K3 gradients (the twins on the CPU) against the JAX
    package's _bwd_proj_kernel in interpret mode, at P = 250 and the
    widths past one dW column block: f32 sum-order noise; in bf16 mode p
    and dz are stored in bf16, and a rounding flip moves a product by one
    bf16 ulp (2^-8) of its largest entry."""
    (h, w, b, tc), want = _jax(S, dtype)
    ts = [torch.tensor(a, requires_grad=True) for a in (h, w, b)]
    loss, _ = sc.softmax_ce_proj_fused(*ts, torch.tensor(tc), S, 0.8,
                                       getattr(torch, dtype))
    got = torch.autograd.grad(loss, ts, torch.tensor(0.37))
    for name, g, ref in zip(("dh", "dW", "db"), got, want):
        scale = max(1.0, float(np.abs(ref).max()))
        tol = (1e-5 if dtype == "float32" else 2.0 ** -8) * scale
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=tol,
                                   err_msg=name)
