"""K5f, the plain tail's forward (ops/softmax_ce.py `softmax_ce_fwd`,
csrc/softmax_ce_plain.cu's plain_fwd_kernel), on the CPU.

The kernel runs only on the card; what surrounds it is held here: its body
edges and hold depths, read from the kernel source against the wrapper
module's mirror (`plain_fwd_plan`); which body and vector width each S and
each base alignment of the logits and of p take; and its division-free p,
e RN(1 / sum) and one FMA correction, emulated in exact arithmetic
against the correctly rounded quotient at every row sum, a saturated one
(at or above 2^126) and an infinite one included. The twin
is held against the JAX package's interpret-mode kernel at the bodies'
edges in tests/test_torch_remat.py; the kernel against the twin on the
card in tests/test_torch_kernels_cuda.py.
"""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from lstm_rnn_tpu_torch.ops import softmax_ce as sc
from tests.test_torch_softmax_ce_wide import _rn32

CSRC = Path(__file__).resolve().parents[1] / "lstm_rnn_tpu_torch" / "csrc"
REAL_MAX = Fraction(float(np.finfo(np.float32).max))


def _plain_src():
    return (CSRC / "softmax_ce_plain.cu").read_text()


def test_k5f_constants_follow_the_kernel_source():
    """plain_fwd_plan's constants are the kernel's, and its launcher picks
    the body by the same edges: a warp a row holding kWarpHoldNarrow
    values a lane up to 32 times that, kWarpHold up to kWarpRowMaxS
    classes, which they cover; the block up to kPlainThreads *
    kBlockHold; three passes above."""
    src = _plain_src()
    c = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
         for n in ("kPlainThreads", "kWarpRowMaxS", "kWarpHoldNarrow",
                   "kWarpHold", "kBlockHold")}
    assert (sc._PLAIN_THREADS, sc._PLAIN_WARP_MAX_S,
            sc._PLAIN_WARP_HOLD_NARROW, sc._PLAIN_WARP_HOLD,
            sc._PLAIN_BLOCK_HOLD) == (
        c["kPlainThreads"], c["kWarpRowMaxS"], c["kWarpHoldNarrow"],
        c["kWarpHold"], c["kBlockHold"])
    assert 32 * c["kWarpHold"] >= c["kWarpRowMaxS"]
    assert c["kPlainThreads"] * c["kBlockHold"] == 10_240
    # every hold is a whole number of the widest vectors (4 values)
    assert all(c[n] % 4 == 0 for n in ("kWarpHoldNarrow", "kWarpHold",
                                       "kBlockHold"))
    launch = re.search(r"cudaError_t plain_fwd_e\(.*?\n}\n", src, re.S)
    body = re.findall(r"(?:if|else if) \((S <= [\w *]+)\)\s*\n\s*"
                      r"plain_fwd_kernel<P, (\w+), E, (\w+)>", launch.group(0))
    assert body == [("S <= 32 * kWarpHoldNarrow", "1", "kWarpHoldNarrow"),
                    ("S <= kWarpRowMaxS", "1", "kWarpHold"),
                    ("S <= kPlainThreads * kBlockHold", "kWarps",
                     "kBlockHold")]
    assert "plain_fwd_kernel<P, kWarps, E, 0>" in launch.group(0)
    # the width: row_vec_elems of a's f32 rows, narrowed by p's
    fwd = re.search(r"cudaError_t plain_fwd\(.*?\n}\n", src, re.S).group(0)
    assert "row_vec_elems(a, static_cast<size_t>(S) * 4, 4)" in fwd
    assert "row_vec_elems(p, static_cast<size_t>(S) * sizeof(P)," in fwd
    common = (CSRC / "softmax_common.cuh").read_text()
    assert "return static_cast<int>((bits & (~bits + 1)) / elem);" in common
    assert "16ull" in common


# (S, a's base in bytes past a 256-byte boundary, p's dtype size or None,
# p's base offset in bytes) -> (body, values held a thread, E)
PLANS = [
    ((7, 0, 4, 0), ("warp", 8, 1)),
    ((183, 0, 2, 0), ("warp", 8, 1)),  # the TIMIT remat tail
    ((256, 0, 4, 0), ("warp", 8, 4)),
    ((257, 0, 4, 0), ("warp", 32, 1)),
    ((1000, 0, 4, 0), ("warp", 32, 4)),
    ((1024, 0, 2, 0), ("warp", 32, 4)),
    ((1025, 0, 4, 0), ("block", 40, 1)),
    ((1026, 0, 2, 0), ("block", 40, 2)),
    ((10112, 0, 4, 0), ("block", 40, 4)),  # the LVCSR remat tail
    ((10112, 0, 2, 0), ("block", 40, 4)),
    ((10112, 0, None, 0), ("block", 40, 4)),
    ((10112, 4, 4, 0), ("block", 40, 1)),  # a view at offset 1
    ((10112, 8, 2, 0), ("block", 40, 2)),
    ((10112, 0, 2, 2), ("block", 40, 1)),  # p one bf16 off
    ((10112, 0, 2, 4), ("block", 40, 2)),
    ((10111, 0, 2, 0), ("block", 40, 1)),  # an odd pitch: narrow in bf16
    ((10240, 0, 4, 0), ("block", 40, 4)),
    ((10241, 0, 4, 0), ("passes", 0, 1)),
    ((12344, 0, 2, 0), ("passes", 0, 4)),
]


@pytest.mark.parametrize("case, want", PLANS)
def test_k5f_body_and_width(case, want):
    S, a_off, p_size, p_off = case
    p_addr = None if p_size is None else (1 << 20) + p_off
    assert sc.plain_fwd_plan(S, (1 << 20) + a_off, p_addr,
                             p_size or 4) == want


@pytest.mark.parametrize("p_size", [4, 2])
def test_k5f_width_is_the_widest_every_row_allows(p_size):
    """E is the widest power of two, up to 4 f32 logits (16 bytes), that
    divides S and aligns every row's start in a (4 E bytes) and in p
    (E p values): every vector load and store the kernel makes lies
    inside its row and aligned to its size."""
    for S in range(1, 70):
        for a_off in range(0, 32, 4):
            for p_off in range(0, 16, p_size):
                a, p = 4096 + a_off, 8192 + p_off
                E = sc.plain_fwd_plan(S, a, p, p_size)[2]
                ok = [w for w in (1, 2, 4) if S % w == 0
                      and all((a + 4 * S * r) % (4 * w) == 0
                              and (p + p_size * S * r) % (p_size * w) == 0
                              for r in range(4))]
                assert E == max(ok), (S, a_off, p_off)


def _k5_p(e, s):
    """softmax_ce_plain.cu's plain_row and plain_p, each operation rounded
    once to binary32 (an FMA once): p from e and the row's exp sum s."""
    if s == float("inf"):
        ss, rs = Fraction(1), Fraction(0)
    else:
        ss, rs = s, _rn32(1 / s)
    q = _rn32(e * rs)
    return _rn32(q + _rn32(e - q * ss) * rs)


def test_k5f_division_free_p_is_correctly_rounded_at_every_row_sum():
    """K5f's p = e / sum with no division, as the source writes it (the
    formula of K3f's ce_div and K4b), equals the correctly rounded
    quotient at row sums from 2^-10 to REAL_MAX (above 2^126, where an e
    saturated at REAL_MAX puts it, RN(1 / sum) is subnormal), for random
    e and for e whose quotient lies next to a rounding midpoint, wherever
    the quotient is normal; an infinite sum gives 0, as the division
    does."""
    src = _plain_src()
    assert "r.sum = finite ? sum : 1.0f;" in src
    assert "r.rs = finite ? __frcp_rn(r.sum) : 0.0f;" in src
    assert "const float q = e * r.rs;" in src
    assert "return fmaf(fmaf(-q, r.sum, e), r.rs, q);" in src
    rng = np.random.RandomState(12)
    f32 = lambda x: Fraction(float(np.float32(x)))  # noqa: E731
    for i in range(4000):
        s = f32(np.ldexp(rng.uniform(1.0, 2.0),
                         rng.randint(124, 128) if i % 2 else
                         rng.randint(-10, 128)))
        if i % 4 < 2:
            e = f32(float(s) * rng.uniform() ** rng.choice([1, 3, 10]))
        else:  # e / s a few ulps of e from a midpoint of p's ulps
            e = _rn32((f32(rng.uniform(0.5, 1.0)) + Fraction(1, 2 ** 25))
                      * s)
        if e == 0 or e > s or e / s < Fraction(2) ** -126:
            continue
        assert _k5_p(e, s) == _rn32(e / s), (float(e), float(s))
    assert _k5_p(REAL_MAX, REAL_MAX) == 1
    assert _k5_p(REAL_MAX, float("inf")) == 0
    assert _k5_p(Fraction(1), float("inf")) == 0


def test_k5f_reads_and_stores_each_row_once():
    """The held bodies read a row with RowVec loads only, store p with
    streaming vector stores of the load's width (store_p: __stcs), and
    divide nowhere; p_t takes the expression of every other p."""
    src = _plain_src()
    kernel = re.search(r"plain_fwd_kernel\(const float\* __restrict__ a.*?"
                       r"\n}\n", src, re.S).group(0)
    # only by E, a power of two known when it compiles (V and the hold)
    divs = re.findall(r"\S+ / \S+", re.sub(r"//.*", "", kernel))
    assert len(divs) == 2 and all(d.endswith(" / E;") for d in divs)
    assert "store_p<P, E>(pr + vi * E, x[i]);" in kernel
    assert "plain_p(plain_exp<false>(ar[t] - off)," in kernel
    store = re.search(r"void store_p\(.*?\n}\n", src, re.S).group(0)
    assert store.count("__stcs(") == 6
    assert "safe_exp(" not in kernel
