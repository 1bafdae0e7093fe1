"""The Hopper kernels against their plain twins, on the card: the LSTM
forward (csrc/lstm_fwd.cu, inference, training, carry/step-mask and
carry-with-residuals variants), its BPTT with and without a carry
(csrc/lstm_bwd.cu), the fused softmax + CE tail (csrc/softmax_ce.cu),
the wide tail (csrc/softmax_ce_wide.cu) and the plain tail
(csrc/softmax_ce_plain.cu), at small and full TIMIT and LVCSR width,
float32 and bfloat16 modes, the wrappers' refusals, the routes of
--remat_blocks training through the carry kernels and the plain tail, the
CHiME recipes' layer and tail shapes, a weight-noise step of the kernel
route against the scan route, and data parallelism: the kernels at a
rank's rows (13 and 25 of the TIMIT recipe's 50, one empty) and a
Trainer(data_group=) step of two ranks (on cuda:0 over gloo; on two GPUs
over NCCL) against the one-process step; and DP x SP and data-parallel
streaming: K6b and K6f at a DP x SP rank's block (B = 25, T = 250), an
all-padding block's outputs exactly zero, K6f+K7 at a streaming rank's 32
streams, and a Trainer(seq_mesh=, data_group=) step of two ranks (on
cuda:0 over gloo, each with a 2-block mesh of cuda:0; on four GPUs over
NCCL, each with a mesh of two) against the one-process SP step; the data
feed: cached epochs against the plain Trainer, bit for bit, in stochastic
and batch mode, epoch 2 copying no byte from the host, and the pinned
staging buffers reused while their copies are in flight; pipeline and
tensor parallelism: a pipelined and a tensor-parallel step on a mesh of
cuda:0 against the one-device step, with their exact launches, and DP x
PP and DP x TP steps of two ranks (on cuda:0 over gloo, each with a mesh
of cuda:0 twice; on four GPUs over NCCL, each with a mesh of two) against
the one-process step on the same kind of mesh; the step graphs
(lstm_rnn_tpu_torch/graphs.py, --fuse_fractions): training and
evaluation steps of a TIMIT-shaped net through warm-up, capture and
replays against the same steps eager, bit for bit, in f32, bf16 and
under remat, with their launches, and the stale-buffer control (a replay
without the next fraction copied in gives another loss); the
tensor-parallel kernels (csrc/lstm_tp.cu): K8f and K8b against their
twins at 125 cells in 5 shards on cuda:0 and 1,024 in 4 shards on four
GPUs, a TP training step through 51 graph replays against the eager
steps bit for bit, and a wait past its bound raising instead of hanging
(`-k tp`).

Needs a CUDA GPU and nvcc: every test carries the `cuda` marker and skips
without a GPU (an autouse fixture decides at run time, so every worker
collects the same tests). The machine with the card has no jax, so run
this file there without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

from lstm_rnn_tpu_torch.ops import lstm_cell
from lstm_rnn_tpu_torch.ops import softmax_ce as sc
from lstm_rnn_tpu_torch.ops.lstm_cell import (lstm_bwd, lstm_bwd_carry,
                                              lstm_fwd_save,
                                              lstm_fwd_save_carry,
                                              lstm_scan_bwd_reference,
                                              lstm_scan_carry_bwd_reference,
                                              lstm_scan_carry_reference,
                                              lstm_scan_fused,
                                              lstm_scan_fused_carry,
                                              lstm_scan_reference)
from lstm_rnn_tpu_torch.ops.softmax_ce import (softmax_ce_bwd_reference,
                                               softmax_ce_fwd_reference,
                                               softmax_ce_proj_bwd,
                                               softmax_ce_proj_fwd)

# f32: true-f32 FMAs in another order than the twin's matmuls, amplified
# through up to 800 recurrent steps (5.7e-7 seen on an H100). bf16: the
# same, plus a different sum order can move h across a bf16 rounding
# boundary and the recurrence carries it (3.9e-3, one bf16 ulp below 1.0,
# seen on an H100): four ulps.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_layer(T, B, P, H, D, seed=0, device="cuda"):
    """Uniform +-0.1 weights (the recipe's init), N(0, 1) inputs, ragged
    lengths including 1 and T."""
    rng = np.random.RandomState(seed)
    u = lambda *s: torch.tensor(rng.uniform(-0.1, 0.1, s),  # noqa: E731
                                dtype=torch.float32, device=device)
    x = torch.tensor(rng.randn(T, B, P), dtype=torch.float32, device=device)
    lengths = rng.randint(1, T + 1, B)
    lengths[0], lengths[-1] = T, 1
    return (x, u(D, P, 4 * H), u(D, H, 4 * H), u(D, 3, H), u(D, 4 * H),
            torch.tensor(lengths, dtype=torch.int32, device=device))


def _max_err(args, dtype, bias_mult=1.0):
    with torch.inference_mode():
        got = lstm_scan_fused(*args, bias_mult, dtype)
        want = lstm_scan_reference(*args, bias_mult, dtype)
        torch.cuda.synchronize()
    assert got.dtype == want.dtype == lstm_cell.storage_dtype(dtype)
    assert got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (9, 5, 7, 5, 1), (9, 5, 7, 5, 2), (13, 11, 131, 130, 2),
    (7, 9, 33, 300, 2)])  # H > 256: one k slice per column quad
def test_small_matches_twin(shape, dtype):
    assert _max_err(make_layer(*shape), dtype, bias_mult=0.7) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_empty_rows_are_zero(dtype):
    """Rows of length 0 (the padding rows of a corpus's last fraction),
    down to a block of rows that has no valid step at all."""
    args = list(make_layer(6, 9, 5, 7, 2, seed=3))
    args[5] = torch.tensor([6, 3, 0, 0, 0, 0, 0, 1, 0], dtype=torch.int32,
                           device="cuda")
    assert _max_err(args, dtype) <= TOL[dtype]
    with torch.inference_mode():
        got = lstm_scan_fused(*args, 1.0, dtype)
    assert not got[:, [2, 3, 4, 5, 6, 8]].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [117, 250])
def test_timit_width_matches_twin(P, dtype):
    assert _max_err(make_layer(800, 50, P, 125, 2, seed=P), dtype) \
        <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_projection_matches_plain_matmul(dtype):
    """The input-projection kernel alone, at shapes off its 64 x 64 x 16
    tiles: a = x . W_in + bias_mult * bias with bf16-rounded operands in
    bf16 mode (products exact in f32)."""
    x, w_in, _, _, bias, _ = make_layer(37, 3, 19, 7, 2)
    with torch.inference_mode():
        got = lstm_cell._launch_proj(x.to(dtype), w_in.to(dtype), bias, 0.7)
        xr, wr = x.to(dtype).float(), w_in.to(dtype).float()
        want = (torch.matmul(xr.reshape(-1, 19), wr)
                + 0.7 * bias[:, None]).view(2, 37, 3, 28)
    assert (got - want).abs().max().item() <= 1e-5


def test_counts_launches():
    args = make_layer(5, 3, 4, 3, 2)
    before = lstm_scan_fused.launches
    with torch.inference_mode():
        lstm_scan_fused(*args)
    assert lstm_scan_fused.launches == before + 1


def test_rejects_what_the_kernel_does_not_take():
    x, w_in, w_rec, peep, bias, lengths = make_layer(5, 3, 4, 3, 2)
    with torch.inference_mode():
        with pytest.raises(TypeError, match="x must be"):
            lstm_scan_fused(x.double(), w_in, w_rec, peep, bias, lengths)
        with pytest.raises(TypeError, match="lengths must be int32"):
            lstm_scan_fused(x, w_in, w_rec, peep, bias, lengths.long())
        with pytest.raises(TypeError, match="peep must be float32"):
            lstm_scan_fused(x, w_in, w_rec, peep.bfloat16(), bias, lengths)
        with pytest.raises(ValueError, match="contiguous"):
            lstm_scan_fused(x.transpose(0, 1).contiguous().transpose(0, 1),
                            w_in, w_rec, peep, bias, lengths)
        with pytest.raises(ValueError, match="is on cpu"):
            lstm_scan_fused(x, w_in, w_rec, peep, bias, lengths.cpu())
        with pytest.raises(ValueError, match="shape"):
            lstm_scan_fused(x, w_in, w_rec[:, :2], peep, bias, lengths)
        with pytest.raises(ValueError, match="compute_dtype"):
            lstm_scan_fused(x, w_in, w_rec, peep, bias, lengths,
                            compute_dtype=torch.float16)
        # contiguous, but one element off the 16-byte vector loads
        shifted = torch.empty(w_rec.numel() + 1, device="cuda")[1:]
        shifted = shifted.view(w_rec.shape).copy_(w_rec)
        with pytest.raises(ValueError, match="aligned"):
            lstm_scan_fused(x, w_in, shifted, peep, bias, lengths)


# ------------------------------------------------- carry and step mask
def carry_inputs(T, B, P, H, D, mask_kind, seed=0):
    """make_layer's operands with non-zero (h0, c0) and a [B, T] step mask:
    "gaps" holds a full row, a row ending mid-chunk, a gap and a restart, a
    row starting mid-chunk, an all-NONE row and random rows; "none" gives
    no mask (the lengths are the validity)."""
    args = make_layer(T, B, P, H, D, seed)
    rng = np.random.RandomState(seed + 100)
    h0 = torch.tensor(rng.uniform(-1, 1, (D, B, H)), dtype=torch.float32,
                      device="cuda")
    c0 = torch.tensor(rng.uniform(-3, 3, (D, B, H)), dtype=torch.float32,
                      device="cuda")
    mask = None
    if mask_kind == "gaps":
        m = rng.rand(B, T) > 0.3
        m[0] = True
        if B > 4:
            m[1, T // 2:] = False
            m[2, T // 3:T // 2] = False
            m[3, :T // 2] = False
            m[4] = False
        mask = torch.tensor(m, device="cuda")
    return args, h0, c0, mask


def _carry_errs(args, h0, c0, mask, dtype, carry_t=None, dir_offset=0):
    """max |kernel - twin| of h, hf and cf."""
    with torch.inference_mode():
        got = lstm_scan_fused_carry(*args, h0, c0, 0.7, True, dtype, True,
                                    carry_t, dir_offset, mask)
        want = lstm_scan_carry_reference(*args, h0, c0, 0.7, dtype, carry_t,
                                         dir_offset, mask)
        torch.cuda.synchronize()
    errs = []
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        errs.append((g.float() - w.float()).abs().max().item())
    return errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, mask_kind, carry_t, dir_offset", [
    ((9, 5, 7, 5, 1), "gaps", None, 0),
    ((9, 5, 7, 5, 1), "none", 6, 0),
    ((9, 5, 7, 5, 1), "gaps", None, 1),
    ((9, 6, 7, 5, 2), "gaps", None, 0),
    ((9, 6, 7, 5, 2), "none", None, 0),
    ((1, 5, 7, 5, 1), "gaps", None, 0),  # T = 1
    ((13, 11, 131, 130, 1), "gaps", 10, 0),
    ((7, 9, 33, 300, 2), "gaps", None, 0),  # H > 256
    ((7, 9, 33, 300, 1), "none", None, 1),
])
def test_carry_matches_twin(shape, mask_kind, carry_t, dir_offset, dtype):
    args, h0, c0, mask = carry_inputs(*shape, mask_kind)
    errs = _carry_errs(args, h0, c0, mask, dtype, carry_t, dir_offset)
    assert max(errs) <= TOL[dtype], errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [117, 250])
def test_carry_streaming_width_matches_twin(P, dtype):
    """One layer of the streaming stack (LSTM(250): W_rec from L2) over a
    64-frame chunk of 64 streams."""
    args, h0, c0, mask = carry_inputs(64, 64, P, 250, 1, "gaps", seed=P)
    assert max(_carry_errs(args, h0, c0, mask, dtype)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dir_offset", [0, 1])
@pytest.mark.parametrize("P", [117, 250])
def test_carry_sp_block_matches_twin(P, dir_offset, dtype):
    """One direction of a TIMIT layer's sequence-parallel block (T=125,
    B=50, H=125), as SP serving launches it: prefix lengths (full, ending
    inside the block, and 0 for a whole kernel block of rows), no mask."""
    args, h0, c0, _ = carry_inputs(125, 50, P, 125, 1, "none", seed=P)
    args[5][4:8] = 0
    errs = _carry_errs(args, h0, c0, None, dtype, None, dir_offset)
    assert max(errs) <= TOL[dtype], errs


def test_carry_all_none_rows_are_zero():
    """Rows with no valid step give h = 0 and a zero final state whatever
    state they entered with; the rows of a block that never reaches
    carry_t - 1 valid still write their final state."""
    args, h0, c0, mask = carry_inputs(8, 9, 5, 7, 1, "gaps", seed=4)
    mask[4:8] = False  # one whole kernel block
    with torch.inference_mode():
        y, (hf, cf) = lstm_scan_fused_carry(*args, h0, c0, step_mask=mask)
    assert not y[:, 4:8].any() and not hf[:, 4:8].any()
    assert not cf[:, 4:8].any()


def test_carry_zero_state_equals_plain_kernel():
    """With zero carries and the lengths as validity, the carry kernel
    gives K0's output."""
    args, h0, _, _ = carry_inputs(9, 6, 7, 5, 2, "none", seed=2)
    z = torch.zeros_like(h0)
    with torch.inference_mode():
        y, _ = lstm_scan_fused_carry(*args, z, z)
        assert torch.equal(y, lstm_scan_fused(*args))


def test_carry_counts_launches_and_refuses():
    args, h0, c0, mask = carry_inputs(5, 3, 4, 3, 1, "gaps")
    before = lstm_scan_fused_carry.launches
    with torch.inference_mode():
        lstm_scan_fused_carry(*args, h0, c0, step_mask=mask)
        assert lstm_scan_fused_carry.launches == before + 1
        with pytest.raises(TypeError, match="h0 must be float32"):
            lstm_scan_fused_carry(*args, h0.double(), c0)
        with pytest.raises(ValueError, match="is on cpu"):
            lstm_scan_fused_carry(*args, h0.cpu(), c0)
        with pytest.raises(ValueError, match="step_mask is on cpu"):
            lstm_scan_fused_carry(*args, h0, c0, step_mask=mask.cpu())
    assert lstm_scan_fused_carry.launches == before + 1


# ------------------------------------------------------------- training
def _rel_err(got, want):
    """max |got - want| over max |want|."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / max(1e-30, want.abs().max().item())
            ).item()


def _elem_rel(got, want):
    """max over elements of |got - want| / |want| (0 where both are 0)."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


# K1 residuals and K2 outputs, relative to the largest entry. f32: true
# f32 in another sum order, through up to 500 recurrent steps forward and
# back. bf16: as TOL, plus the deltas stored in bf16 can round the other
# way and every weight-gradient sum downstream moves by up to a bf16 ulp.
REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}

TRAIN_SHAPES = [(9, 5, 7, 5, 1), (9, 5, 7, 5, 2), (13, 11, 131, 130, 2),
                (60, 50, 117, 125, 2), (60, 50, 250, 125, 2)]


def _empty_block(args):
    """Rows 4-7 (one whole kernel block) empty, row 1 of length 1."""
    args = list(args)
    lengths = args[5].clone()
    if lengths.numel() >= 8:
        lengths[4:8] = 0
    lengths[1] = 1
    args[5] = lengths
    return args


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_fwd_save_matches_twin(shape, dtype):
    args = _empty_block(make_layer(*shape))
    got = lstm_fwd_save(*args, 0.7, dtype)
    want = lstm_scan_reference(*args, 0.7, dtype, save=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("h", "c", "gates"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        assert _rel_err(g, w) <= REL[dtype], (name, _rel_err(g, w))
    # padding (and the empty block) is exactly zero in every residual
    valid = (torch.arange(shape[0], device="cuda")[:, None]
             < args[5][None, :])
    assert not got[1][:, ~valid].any() and not got[2][:, ~valid].any()
    # the inference forward gives the same h
    with torch.inference_mode():
        h0 = lstm_scan_fused(*args, 0.7, dtype)
    assert torch.equal(h0, got[0])


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_bwd_matches_twin(shape, dtype, need_dx):
    args = _empty_block(make_layer(*shape, seed=5))
    T, B, _, H, D = shape
    h, c, gates = lstm_fwd_save(*args, 0.7, dtype)
    dh = torch.randn(T, B, D * H, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(1)) * 3.0
    x, w_in, w_rec, peep, _, lengths = args
    got = lstm_bwd(x, w_in, w_rec, peep, lengths, h, c, gates, dh, 0.7,
                   True, dtype, need_dx)
    want = lstm_scan_bwd_reference(x, w_in, w_rec, peep, lengths, h, c,
                                   gates, dh, 0.7, True, dtype, need_dx)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "dW_in", "dW_rec", "dpeep", "dbias"), got,
                          want):
        if not need_dx and name == "dx":
            assert g is None and w is None
            continue
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= REL[dtype], (name, _rel_err(g, w))
    if need_dx and B >= 8:
        assert not got[0][:, 4:8].any()  # the empty block's dx


def test_autograd_routes_through_the_training_kernels():
    args = [t.requires_grad_(i < 5) for i, t in
            enumerate(make_layer(7, 6, 5, 4, 2))]
    before = (lstm_scan_fused.launches, lstm_fwd_save.launches,
              lstm_bwd.launches)
    lstm_scan_fused(*args).sum().backward()
    assert (lstm_scan_fused.launches, lstm_fwd_save.launches,
            lstm_bwd.launches) == (before[0], before[1] + 1, before[2] + 1)
    assert all(t.grad is not None for t in args[:5])


def _tail(N, P, S, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    h = torch.randn(N, P, device="cuda", generator=g) * 0.5
    w = (torch.rand(P, S, device="cuda", generator=g) - 0.5) * 0.2
    b = (torch.rand(S, device="cuda", generator=g) - 0.5) * 0.2
    tc = torch.randint(0, S, (N,), device="cuda", generator=g,
                       dtype=torch.int32)
    tc[::7] = -1
    return h, w, b, tc


# the tail: f32 true-f32 sums in another order; bf16 p and dz stored in
# bf16 (a rounding flip moves a product by up to one bf16 ulp)
TAIL_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# p element by element against its own size: f32 sums in another order;
# bf16 both sides round the same f32 value, and a rounding flip moves p by
# one bf16 ulp, at most 2^-7 of |p|
P_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(70, 7, 5), (1000, 131, 65),
                                   (2500, 250, 183)])
def test_tail_matches_twin(shape, dtype):
    h, w, b, tc = _tail(*shape)
    loss, cnt, p = softmax_ce_proj_fwd(h, w, b, tc, 0.8, dtype)
    loss_r, cnt_r, p_r = softmax_ce_fwd_reference(h, w, b, tc, 0.8, dtype)
    loss0, cnt0, p0 = softmax_ce_proj_fwd(h, w, b, tc, 0.8, dtype,
                                          want_p=False)
    torch.cuda.synchronize()
    assert p0 is None and loss0.item() == loss.item()
    assert abs(loss.item() - loss_r.item()) <= 1e-5 * abs(loss_r.item())
    # a near-tie between the two sum orders may flip one argmax
    assert abs(cnt.item() - cnt_r.item()) <= 1 and cnt0.item() == cnt.item()
    assert _elem_rel(p, p_r) <= P_REL[dtype], _elem_rel(p, p_r)
    # the check rejects a zero, a uniform and a column-rolled p
    for wrong in (torch.zeros_like(p_r), torch.full_like(p_r, 1.0 / shape[2]),
                  p_r.roll(1, dims=1)):
        assert _elem_rel(wrong, p_r) > P_REL[dtype]
    g = torch.tensor(0.37, device="cuda")
    got = softmax_ce_proj_bwd(p, h, w, tc, g, 0.8, dtype)
    want = softmax_ce_bwd_reference(p, h, w, tc, g, 0.8, dtype)
    torch.cuda.synchronize()
    for name, x, y in zip(("dh", "dW", "db"), got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert _rel_err(x, y) <= TAIL_REL[dtype], (name, _rel_err(x, y))
    assert not got[0][::7].any()  # dummy rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [117, 250])
@pytest.mark.parametrize("S", [183, 256, 257, 704])
def test_tail_fwd_at_every_body(S, P, dtype):
    """K3f on each of its bodies: one pass of 3 or 4 chunks (S = 183,
    256; bf16 with the softmax on the accumulators) and the passes into
    the shared logits block (257, and 704, the H100's limit), h rows 4- or
    2-byte aligned (P = 250, 117), N off the 64-row tile, bias_mult 0.8,
    dummy rows; without p the same loss and count; a second launch bit for
    bit equal to the first."""
    h, w, b, tc = _tail(1037, P, S, seed=S + P)
    hs, ws = h.to(dtype), w.to(dtype)
    loss, cnt, p = softmax_ce_proj_fwd(hs, ws, b, tc, 0.8, dtype)
    loss2, cnt2, p2 = softmax_ce_proj_fwd(hs, ws, b, tc, 0.8, dtype)
    loss0, cnt0, p0 = softmax_ce_proj_fwd(hs, ws, b, tc, 0.8, dtype,
                                          want_p=False)
    loss_r, cnt_r, p_r = softmax_ce_fwd_reference(hs, ws, b, tc, 0.8, dtype)
    torch.cuda.synchronize()
    assert p0 is None and p.dtype == p_r.dtype == hs.dtype
    assert torch.equal(p, p2) and loss2.item() == loss.item() == loss0.item()
    assert cnt2.item() == cnt.item() == cnt0.item()
    assert abs(loss.item() - loss_r.item()) <= 1e-5 * abs(loss_r.item())
    # a near-tie between the two sum orders may flip one argmax
    assert abs(cnt.item() - cnt_r.item()) <= 1
    assert _elem_rel(p, p_r) <= P_REL[dtype], _elem_rel(p, p_r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [183, 257])
def test_tail_fwd_counts_the_first_of_tied_maxima(S, dtype):
    """Columns 1 and 3 of W are equal and far the largest logits of every
    row: p ties there bit for bit, and the count takes the first argmax
    (column 1), exactly."""
    h, w, b, tc = _tail(300, 117, S, seed=5)
    h = h.abs()
    w[:, 1] = w[:, 3] = 0.3
    b[3] = b[1]
    tc[:] = 1
    tc[150:] = 3
    tc[::7] = -1
    for targets, want in ((tc, int(((tc == 1)).sum())),
                          (torch.where(tc >= 0, 3, -1).to(tc), 0)):
        loss, cnt, p = softmax_ce_proj_fwd(h, w, b, targets, 0.8, dtype)
        torch.cuda.synchronize()
        assert torch.equal(p[:, 1], p[:, 3])
        assert (p.float().argmax(dim=1) == 1).all()
        assert cnt.item() == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("S", [7, 10111, 10112, 12345])
def test_wide_fwd_at_any_alignment(S, offset, dtype):
    """K4f on logits whose base is 16-byte aligned or one element off it
    (a contiguous view at storage offset 1), at an odd pitch (10,111), a
    tiny row (7), the LVCSR width (10,112: 16-byte loads) and a row wider
    than its register holding (12,345: the multi-pass body): the stats
    element by element, the loss and the count against the twin, a second
    launch bit for bit; rows whose maxima tie count their first."""
    N = 300
    g = torch.Generator("cuda").manual_seed(S + offset)
    buf = torch.randn(N * S + offset, device="cuda", generator=g) * 3
    a = buf.to(dtype)[offset:].view(N, S)
    assert a.is_contiguous() and a.storage_offset() == offset
    tc = torch.randint(0, S, (N,), device="cuda", generator=g,
                       dtype=torch.int32)
    tc[::7] = -1
    got = sc._launch_wide_fwd(a, tc)
    again = sc._launch_wide_fwd(a, tc)
    loss_r, cnt_r, *stats_r = sc.wide_stats_reference(a, tc)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    loss, cnt, *stats = got
    assert abs(loss.item() - loss_r.item()) <= 1e-5 * abs(loss_r.item())
    assert abs(cnt.item() - cnt_r.item()) <= 1
    for name, x, y in zip(("off", "ssum", "pt"), stats, stats_r):
        assert _elem_rel(x, y) <= STAT_REL, (name, _elem_rel(x, y))
    if S > 3:  # every row ties at columns 1 and 3, far above the rest
        a[:, 1] = a[:, 3] = 100.0
        ones = torch.where(tc >= 0, 1, -1).to(tc)
        assert sc._launch_wide_fwd(a, ones)[1].item() == int((tc >= 0).sum())


def test_tail_too_wide_for_shared_memory_raises():
    """An LVCSR-scale softmax (10112 states) does not fit the kernel's
    shared memory: the wrapper refuses it and names the wide tail."""
    h, w, b, tc = _tail(64, 8, 10112)
    with pytest.raises(ValueError, match="softmax_ce_wide_fused"):
        softmax_ce_proj_fwd(h, w, b, tc)


# the wide tail (K4). Stats element by element: f32 math on the same
# logits in both modes, sums in another order. dz relative to its largest
# entry: f32 sum-order noise in p; bf16 both sides round the same f32
# value, a rounding flip moves dz by one bf16 ulp. dW, dh: f32 sums in
# another order; bf16 each flip of dz moves the products by up to one bf16
# ulp.
STAT_REL = 1e-5
DZ_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
WIDE_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, bias_mult", [
    ((70, 7, 1001), 0.8), ((1000, 131, 2049), 0.8),
    ((2500, 250, 10112), 0.8),
    ((600, 256, 1001), 0.8),  # one whole pass of 256 rows of dW
    ((600, 300, 2049), 0.8),  # two passes
    ((25_000, 250, 10112), 1.0)])  # the LVCSR tail and recipe
def test_wide_tail_matches_twin(shape, bias_mult, dtype):
    """S off every multiple of 32/64/128 but the last, N off the 64-row
    tile; the first tile's rows are all dummies. K4b launched twice gives
    the same bits (its row splits are summed in a fixed order)."""
    h, w, b, tc = _tail(*shape)
    tc[:64] = -1
    loss, cnt, a, off, ssum, pt = sc.softmax_ce_wide_fwd(h, w, b, tc,
                                                         bias_mult, dtype)
    loss_r, cnt_r, off_r, ssum_r, pt_r = sc.wide_stats_reference(a, tc)
    torch.cuda.synchronize()
    assert a.dtype == lstm_cell.storage_dtype(dtype)
    assert abs(loss.item() - loss_r.item()) <= 1e-5 * abs(loss_r.item())
    assert abs(cnt.item() - cnt_r.item()) <= 1
    for name, x, y in (("off", off, off_r), ("ssum", ssum, ssum_r),
                       ("pt", pt, pt_r)):
        assert _elem_rel(x, y) <= STAT_REL, (name, _elem_rel(x, y))
    loss0, cnt0, _, *none = sc.softmax_ce_wide_fwd(h, w, b, tc, bias_mult,
                                                   dtype, want_stats=False)
    assert none == [None] * 3 and loss0.item() == loss.item()
    g = torch.tensor(0.37, device="cuda")
    hc = h.to(a.dtype)
    dz, dw, db = sc._launch_wide_bwd(a, hc, tc, off, ssum, pt, g, bias_mult)
    again = sc._launch_wide_bwd(a, hc, tc, off, ssum, pt, g, bias_mult)
    dz_r = sc.wide_dz_reference(a, tc, off, ssum, pt, g).to(a.dtype)
    got = sc.softmax_ce_wide_bwd(a, h, w, tc, off, ssum, pt, g, bias_mult,
                                 dtype)
    want = sc.softmax_ce_wide_bwd_reference(a, h, w, tc, off, ssum, pt, g,
                                            bias_mult, dtype)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip((dz, dw, db), again))
    assert _rel_err(dz, dz_r) <= DZ_REL[dtype], _rel_err(dz, dz_r)
    for name, x, y in zip(("dh", "dW", "db"), got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert _rel_err(x, y) <= WIDE_REL[dtype], (name, _rel_err(x, y))
    # the all-dummy tile: exactly zero
    assert not dz[:64].any() and not got[0][:64].any()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(70, 7, 1001), (1000, 131, 2049),
                                   (2500, 250, 10112)])
def test_wide_bf16_products_match_twin(shape, out_dtype):
    """K4's two products outside its kernels in bf16 mode, on the tensor
    cores (gemm.cuh's GemmTailLogits and GemmWideDh), against their twins
    in f32 on the bf16 values: the logits rounded to bf16 on both sides
    (a sum on the other side of a rounding boundary moves an element by
    one bf16 ulp: DZ_REL), dh f32 sums in another order or rounded to
    bf16 (WIDE_REL); S off the 64/128 multiples, the first tile's rows
    all dummies (their dh exactly zero); one engine launch each."""
    from lstm_rnn_tpu_torch.ops.gemm import LAUNCHES
    bf = torch.bfloat16
    h, w, b, tc = _tail(*shape)
    tc[:64] = -1
    before = {u: LAUNCHES[u].launches for u in ("tail_logits", "wide_dh")}
    a = sc.wide_logits(h, w, b, 0.8, bf)
    a_r = sc.wide_logits_reference(h, w, b, 0.8, bf)
    _, _, off, ssum, pt = sc.wide_stats_reference(a, tc)
    dzc = sc.wide_dz_reference(a, tc, off, ssum, pt,
                               torch.tensor(0.37, device="cuda")).to(bf)
    dh = sc._wide_dh(dzc, w, out_dtype, bf)
    dh_r = sc.wide_dh_reference(dzc, w, out_dtype, bf)
    no_bias = sc.wide_logits(h, w, torch.zeros_like(b), 0.8, bf)
    torch.cuda.synchronize()
    assert a.dtype == bf and a.shape == a_r.shape
    assert _rel_err(a, a_r) <= DZ_REL[bf], _rel_err(a, a_r)
    assert _rel_err(no_bias, a_r) > DZ_REL[bf]  # the check sees the bias
    assert dh.dtype == out_dtype and dh.shape == dh_r.shape
    assert _rel_err(dh, dh_r) <= WIDE_REL[bf], _rel_err(dh, dh_r)
    assert not dh[:64].any()
    assert {u: LAUNCHES[u].launches - n for u, n in before.items()} == {
        "tail_logits": 2, "wide_dh": 1}


def test_loss_and_count_fused_takes_the_wide_tail():
    """At the LVCSR recipe's 10,112 states the network's tail is K4 (one
    forward and one backward launch), never K3."""
    from lstm_rnn_tpu_torch.network import Network
    net = Network([
        {"name": "input", "type": "input", "size": 5},
        {"name": "l1", "type": "blstm", "size": 8, "bias": 1.0},
        {"name": "output", "type": "softmax", "size": 10112, "bias": 1.0},
        {"name": "postoutput", "type": "multiclass_classification",
         "size": 10112}])
    net.init_params(3)
    params = net.device_params("cuda")
    for layer in params.values():
        for v in layer.values():
            v.requires_grad_(True)
    g = torch.Generator("cuda").manual_seed(2)
    x = torch.randn(9, 4, 5, device="cuda", generator=g)
    pt = torch.ones(9, 4, dtype=torch.int8, device="cuda")
    tc = torch.randint(0, 10112, (9, 4), device="cuda", generator=g,
                       dtype=torch.int32)
    from lstm_rnn_tpu_torch.ops.gemm import LAUNCHES
    wrappers = (sc.softmax_ce_proj_fwd, sc.softmax_ce_proj_bwd,
                sc.softmax_ce_wide_fwd, sc.softmax_ce_wide_bwd,
                LAUNCHES["tail_dW"], LAUNCHES["tail_dh"])
    before = [f.launches for f in wrappers]
    loss, _ = net.loss_and_count_fused(params, x, tc, pt)
    loss.backward()
    torch.cuda.synchronize()
    # K4b computes its dW in its own kernel: no engine tail product
    assert [f.launches - n for f, n in zip(wrappers, before)] == [
        0, 0, 1, 1, 0, 0]
    assert torch.isfinite(params["output"]["W"].grad).all()


# ------------------------------------------------ carry with gradients (K6b)
def _carry_grad_inputs(shape, seed, lens_kind):
    """make_layer's operands with non-zero (h0, c0), dhf and dcf, and
    lengths "full", "ragged" (rows ending inside the block, one block of
    empty rows, a row of length 1) or all of them."""
    T, B, _, H, D = shape
    args = list(make_layer(*shape, seed=seed))
    if lens_kind == "ragged":
        args = _empty_block(args)
    else:
        args[5] = torch.full((B,), T, dtype=torch.int32, device="cuda")
    g = torch.Generator("cuda").manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        D, B, H, device="cuda", generator=g)
    h0, c0, dhf, dcf = u(-1, 1), u(-3, 3), u(-2, 2), u(-2, 2)
    dh = torch.randn(T, B, D * H, device="cuda", generator=g) * 3.0
    return args, h0, c0, dh, dhf, dcf


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, lens_kind, carry_t, dir_offset", [
    ((9, 5, 7, 5, 1), "full", None, 0),
    ((9, 5, 7, 5, 1), "full", 6, 0),
    ((9, 5, 7, 5, 1), "full", None, 1),
    ((9, 9, 7, 5, 2), "ragged", None, 0),
    ((13, 11, 131, 130, 1), "ragged", 10, 0),
    ((13, 11, 131, 130, 1), "ragged", None, 1),
    ((7, 9, 33, 300, 1), "ragged", None, 1),  # H > 256
    ((1, 5, 7, 5, 1), "full", None, 1),  # T = 1
    ((125, 50, 250, 125, 1), "ragged", None, 1),  # an SP block of TIMIT
])
def test_carry_grad_matches_twin(shape, lens_kind, carry_t, dir_offset,
                                 dtype, need_dx):
    """K6b forward (h, c, gates, hf, cf) and backward (dx, the weight
    gradients, dh0, dc0) against their twins."""
    args, h0, c0, dh, dhf, dcf = _carry_grad_inputs(shape, 3, lens_kind)
    got = lstm_fwd_save_carry(*args, h0, c0, 0.7, dtype, carry_t, dir_offset)
    want = lstm_scan_carry_reference(*args, h0, c0, 0.7, dtype, carry_t,
                                     dir_offset, save=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("h", "c", "gates", "hf", "cf"),
                          (*got[:3], *got[3]), (*want[:3], *want[3])):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        assert _rel_err(g, w) <= REL[dtype], (name, _rel_err(g, w))
    h, c, gates, _ = got
    x, w_in, w_rec, peep, _, lengths = args
    bwd = (x, w_in, w_rec, peep, lengths, h, c, gates, h0, c0, dh, dhf, dcf,
           0.7, True, dtype, need_dx, carry_t, dir_offset)
    got = lstm_bwd_carry(*bwd)
    want = lstm_scan_carry_bwd_reference(*bwd)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "dW_in", "dW_rec", "dpeep", "dbias", "dh0",
                           "dc0"), got, want):
        if not need_dx and name == "dx":
            assert g is None and w is None
            continue
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= REL[dtype], (name, _rel_err(g, w))
    if lens_kind == "ragged" and shape[1] >= 8:
        # the empty block: no gradient in or out
        assert not got[5][:, 4:8].any() and not got[6][:, 4:8].any()


def test_carry_grad_zero_state_equals_training_kernels():
    """Zero carries and cotangents: the K6b kernels give K1's residuals and
    K2's gradients on a BLSTM layer (one launch each, D = 2)."""
    args, h0, _, dh, _, _ = _carry_grad_inputs((9, 9, 7, 5, 2), 4, "ragged")
    z = torch.zeros_like(h0)
    h, c, g, _ = lstm_fwd_save_carry(*args, z, z, 0.7)
    h1, c1, g1 = lstm_fwd_save(*args, 0.7)
    assert torch.equal(h, h1) and torch.equal(c, c1) and torch.equal(g, g1)
    x, w_in, w_rec, peep, _, lengths = args
    got = lstm_bwd_carry(x, w_in, w_rec, peep, lengths, h, c, g, z, z, dh, z,
                         z, 0.7)
    want = lstm_bwd(x, w_in, w_rec, peep, lengths, h, c, g, dh, 0.7)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= 1e-6


def test_carry_autograd_routes_through_k6b_and_counts():
    args, h0, c0, _, _, _ = _carry_grad_inputs((7, 6, 5, 4, 1), 5, "full")
    args = [t.requires_grad_(i < 5) for i, t in enumerate(args)]
    h0.requires_grad_(True)
    before = (lstm_scan_fused_carry.launches, lstm_fwd_save_carry.launches,
              lstm_bwd_carry.launches)
    y, (hf, cf) = lstm_scan_fused_carry(*args, h0, c0, dir_offset=1)
    (y.sum() + hf.sum()).backward()
    assert h0.grad is not None and torch.isfinite(h0.grad).all()
    assert (lstm_scan_fused_carry.launches, lstm_fwd_save_carry.launches,
            lstm_bwd_carry.launches) == (before[0], before[1] + 1,
                                         before[2] + 1)
    with pytest.raises(TypeError, match="dhf must be float32"):
        h, c, g, _ = lstm_fwd_save_carry(*[a.detach() for a in args],
                                         h0.detach(), c0)
        lstm_bwd_carry(args[0], args[1], args[2], args[3], args[5], h, c, g,
                       h0.detach(), c0, torch.zeros_like(h),
                       hf.detach().double(), cf.detach())


# ------------------------------------------------------ the plain tail (K5)
# p element by element (P_REL); dz relative to its largest entry: f32 sum-
# order noise in p; bf16 dz comes from the same stored p on both sides
PLAIN_DZ_REL = 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, offset", [
    ((70, 7), 0), ((1000, 183), 0), ((1000, 256), 0), ((1000, 257), 0),
    ((1000, 1024), 0), ((1000, 1025), 0),
    ((2500, 10112), 0), ((300, 10112), 1), ((300, 10111), 0),
    ((300, 10240), 0), ((300, 10241), 0)])
def test_plain_tail_matches_twin(shape, offset, dtype):
    """K5f and K5b against their twins, one warp per row (S <= 1024: 8
    values a lane up to 256, 32 above), one block per row holding it in
    registers (S <= 10,240) and three passes
    above, at each body's edges; 16-byte vectors (S = 10,112), an odd
    pitch (10,111: one value a vector) and logits 4 bytes off 16-byte
    alignment (a view into a flat buffer at offset 1); dummy rows, a tied
    maximum and a row whose exp sum overflows. A second launch gives the
    same bits; the tied row counts its first maximum only."""
    N, S = shape
    g = torch.Generator("cuda").manual_seed(N + S + offset)
    buf = torch.randn(N * S + offset, device="cuda", generator=g) * 3
    a = buf[offset:].view(N, S)
    assert a.is_contiguous() and a.storage_offset() == offset
    tc = torch.randint(0, S, (N,), device="cuda", generator=g,
                       dtype=torch.int32)
    tc[::7] = -1
    a[1] = 0.0
    a[1, 2] = a[1, 4] = 5.0
    tc[1] = 2
    a[2] = -3e30
    a[2, 0] = a[2, S - 1] = 0.0
    sd = lstm_cell.storage_dtype(dtype)
    body = "warp" if S <= 1024 else "block" if S <= 10240 else "passes"
    E = 1 if offset or S % 2 else 4 if S % 4 == 0 else 2
    assert sc.plain_fwd_plan(S, a.data_ptr(), 1 << 20, sd.itemsize)[::2] == (
        body, E)
    loss, cnt, p = sc.softmax_ce_fwd(a, tc, dtype)
    loss2, cnt2, p2 = sc.softmax_ce_fwd(a, tc, dtype)
    loss_r, cnt_r, p_r = sc.plain_fwd_reference(a, tc, dtype)
    loss0, cnt0, p0 = sc.softmax_ce_fwd(a, tc, dtype, want_p=False)
    torch.cuda.synchronize()
    assert p.dtype == sd and p0 is None
    assert torch.equal(p, p2) and loss2.item() == loss.item()
    assert cnt2.item() == cnt.item()
    assert loss0.item() == loss.item() and cnt0.item() == cnt.item()
    assert abs(loss.item() - loss_r.item()) <= 1e-5 * abs(loss_r.item())
    assert abs(cnt.item() - cnt_r.item()) <= 1
    assert _elem_rel(p, p_r) <= P_REL[dtype], _elem_rel(p, p_r)
    for wrong in (torch.zeros_like(p_r), p_r.roll(1, dims=1)):
        assert _elem_rel(wrong, p_r) > P_REL[dtype]
    # the tied row alone: its first maximum (2) counts, its second (4) not
    one = a[1:2].clone()
    for t, want in ((2, 1), (4, 0)):
        tt = torch.tensor([t], device="cuda", dtype=torch.int32)
        _, c1, p1 = sc.softmax_ce_fwd(one, tt, dtype)
        torch.cuda.synchronize()
        assert p1[0, 2] == p1[0, 4] and c1.item() == want
    gl = torch.tensor(0.37, device="cuda")
    dz = sc.softmax_ce_bwd(p, tc, gl)
    dz_r = sc.plain_dz_reference(p, tc, gl)
    torch.cuda.synchronize()
    assert dz.dtype == torch.float32 and dz.shape == (N, S)
    assert _rel_err(dz, dz_r) <= PLAIN_DZ_REL, _rel_err(dz, dz_r)
    assert not dz[::7].any() and torch.isfinite(dz).all()
    assert _rel_err(torch.zeros_like(dz_r), dz_r) > PLAIN_DZ_REL


def test_plain_tail_counts_and_refuses():
    a = torch.randn(9, 5, device="cuda")
    a.requires_grad_(True)
    tc = torch.randint(0, 5, (9,), device="cuda", dtype=torch.int32)
    before = (sc.softmax_ce_fwd.launches, sc.softmax_ce_bwd.launches)
    loss, _ = sc.softmax_ce_fused(a, tc, 5)
    loss.backward()
    torch.cuda.synchronize()
    assert (sc.softmax_ce_fwd.launches, sc.softmax_ce_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(a.grad).all()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sc.softmax_ce_bwd(torch.zeros(9, 5, device="cuda",
                                      dtype=torch.float16), tc,
                          torch.tensor(1.0, device="cuda"))
    with pytest.raises(ValueError, match="targets"):
        sc.softmax_ce_fwd(a.detach(), tc[:4])


def test_remat_step_routes_through_carry_kernels_and_k5():
    """A remat_blocks=3 training step on a two-layer net (T = 8: padded
    to 9) launches per layer and direction 3 K6b-f forward, 3 more in the
    recompute and 3 K6b-b, one K5f and one K5b, nothing of K0-K4; its
    loss and gradients equal the plain kernel step's."""
    from lstm_rnn_tpu_torch.network import Network
    layers = [{"name": "input", "type": "input", "size": 5},
              {"name": "l1", "type": "blstm", "size": 8, "bias": 1.0},
              {"name": "l2", "type": "lstm", "size": 6, "bias": 1.0},
              {"name": "output", "type": "softmax", "size": 11, "bias": 1.0},
              {"name": "postoutput", "type": "multiclass_classification",
               "size": 11}]
    gen = torch.Generator("cuda").manual_seed(4)
    x = torch.randn(8, 4, 5, device="cuda", generator=gen)
    lengths = torch.tensor([8, 5, 1, 3], device="cuda")
    pt = (torch.arange(8, device="cuda")[:, None] < lengths).to(torch.int8)
    tc = torch.randint(0, 11, (8, 4), device="cuda", generator=gen,
                       dtype=torch.int32)
    tc[pt == 0] = -1
    wrappers = {"k0": lstm_scan_fused, "k1": lstm_fwd_save, "k2": lstm_bwd,
                "k6f": lstm_scan_fused_carry, "k6bf": lstm_fwd_save_carry,
                "k6bb": lstm_bwd_carry, "k3f": sc.softmax_ce_proj_fwd,
                "k3b": sc.softmax_ce_proj_bwd, "k4f": sc.softmax_ce_wide_fwd,
                "k4b": sc.softmax_ce_wide_bwd, "k5f": sc.softmax_ce_fwd,
                "k5b": sc.softmax_ce_bwd}
    out = {}
    for k in (0, 3):
        net = Network(layers)
        net.init_params(3)
        net.remat_blocks = k
        params = net.device_params("cuda")
        leaves = [params[n][j] for n in sorted(params)
                  for j in sorted(params[n])]
        for v in leaves:
            v.requires_grad_(True)
        before = {n: f.launches for n, f in wrappers.items()}
        loss, _ = net.loss_and_count_fused(params, x, tc, pt)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[k] = (loss.item(), grads, {n: f.launches - before[n]
                                        for n, f in wrappers.items()
                                        if f.launches != before[n]})
    assert out[3][2] == {"k6bf": 18, "k6bb": 9, "k5f": 1, "k5b": 1}
    assert out[0][2] == {"k1": 2, "k2": 2, "k3f": 1, "k3b": 1}
    assert out[3][0] == pytest.approx(out[0][0], rel=1e-5)
    for got, want in zip(out[3][1], out[0][1]):
        assert _rel_err(got, want) <= 1e-4


# ------------------------------------------------- the GEMM engine (gemm.cuh)
from lstm_rnn_tpu_torch.ops import gemm as ge  # noqa: E402
from lstm_rnn_tpu_torch.ops.gemm import View  # noqa: E402

# the engine against its twin, relative to each output's largest entry:
# f32 sums in another order (true f32 on both sides); in bf16 the products
# are exact and the sums f32, the tensor cores adding in another order;
# where the output is rounded to bf16 (dx's planes, the tail's dh), a sum
# on the other side of a rounding boundary moves it by one bf16 ulp
GEMM_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
GEMM_ROUNDED_REL = 2.0 ** -7


def gemm_case(name, dtype, seed=0):
    return ge.main_path_case(name, dtype, "cuda",
                             torch.Generator("cuda").manual_seed(seed))


# the main path's products (ops/gemm.py: 25,000 rows of the training
# fraction; the projection also over 40,000, 6,250 and 4,096 rows)
GEMM_CASES = ge.MAIN_PATH_CASES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", GEMM_CASES)
def test_gemm_matches_twin_at_main_path_shapes(name, dtype):
    use, a, b, M, N, K, kw = gemm_case(name, dtype)
    got = ge.gemm(use, a, b, M, N, K, compute_dtype=dtype, **kw)
    want = ge.gemm_reference(use, a, b, M, N, K, compute_dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = (GEMM_ROUNDED_REL if dtype == torch.bfloat16
           and use in ("dx", "tail_dh") else GEMM_REL[dtype])
    assert _rel_err(got, want) <= tol, _rel_err(got, want)
    assert _rel_err(torch.zeros_like(want), want) > tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use", ge.USES)
def test_gemm_small_odd_shapes_match_twin(use, dtype):
    """Every product at widths that end inside a tile and a K that ends
    inside a stage, split-K where the product splits."""
    g = torch.Generator("cuda").manual_seed(7)

    def t(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)
    M, N, K = 131, 67, 203
    ta, tb = ge.TRANSPOSE[use]
    npairs = 2 if use in ("proj", "dW_in", "dW_rec", "dx") else 1
    a_t, b_t = t(npairs, K if ta else M, M if ta else K), \
        t(npairs, N if tb else K, K if tb else N)
    ar, ac = a_t.shape[1:]
    br, bc = b_t.shape[1:]
    shifts = (-3, 3) if use == "dW_rec" else (0, 0)
    a = [View(a_t, p * ar * ac, ac, ar, ac, shifts[p]) for p in range(npairs)]
    b = [View(b_t, p * br * bc, bc, br, bc) for p in range(npairs)]
    kw = {}
    if use == "dx":
        kw["ngroups"] = 2
    elif npairs == 2:
        kw["outputs"] = 2
    if use in ge.SPLIT_USES:
        kw["nsplit"] = 3
    if use == "proj":
        kw.update(bias=torch.randn(2, N, device="cuda", generator=g),
                  bias_mult=0.5)
    got = ge.gemm(use, a, b, M, N, K, compute_dtype=dtype, **kw)
    want = ge.gemm_reference(use, a, b, M, N, K, compute_dtype=dtype, **kw)
    torch.cuda.synchronize()
    tol = (GEMM_ROUNDED_REL if dtype == torch.bfloat16
           and use in ("dx", "tail_dh") else GEMM_REL[dtype])
    assert _rel_err(got, want) <= tol, _rel_err(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_is_bitwise_repeatable(dtype):
    """Split-K partials summed in a fixed order: two launches on the same
    inputs give the same bits."""
    for name in ("dW_in:250", "dx"):
        use, a, b, M, N, K, kw = gemm_case(name, dtype, seed=3)
        first = ge.gemm(use, a, b, M, N, K, compute_dtype=dtype, **kw)
        second = ge.gemm(use, a, b, M, N, K, compute_dtype=dtype, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_gemm_counts_launches_by_use():
    """A training step's BPTT and projection launches count in the
    engine's uses: one proj per forward, dW_in and dW_rec per backward,
    dx where the layer's input needs a gradient."""
    args = make_layer(6, 3, 5, 4, 2)
    for c in ge.LAUNCHES.values():
        c.launches = 0
    x = args[0].clone().requires_grad_(True)
    w_in = args[1].clone().requires_grad_(True)
    out = lstm_scan_fused(x, w_in, *args[2:], 1.0, torch.float32)
    out.sum().backward()
    torch.cuda.synchronize()
    want = dict(proj=1, dW_in=1, dW_rec=1, dx=1, tail_dh=0, tail_dW=0,
                tail_logits=0, wide_dh=0)
    want.update({f"{u}:3x": 0 for u in list(want)})
    assert {u: c.launches for u, c in ge.LAUNCHES.items()} == want


# --f32_matmul 3x (gemm.cuh's gemm3x_kernel, softmax_ce_wide.cu's
# wide_bwd_3x_kernel) against the twins' split products: f32 sums in
# another order (the kernel adds the three passes into one accumulator,
# the twin adds three finished products), relative to each output's
# largest entry; the 3x product against the exact f32 one within the
# mode's contract, and the 1-pass bf16 product, the control, outside it
THREE_PASS_REL = 2.0 ** -14
# K4's long reductions in 3x against the 3x twins: inside each 64-k stage
# the tensor cores add without f32's round to nearest; an H100 read 1.1e-5
# to 1.4e-5 for dh over K = 2,049-10,112 (the engine's main-path shapes
# hold GEMM_REL)
THREE_PASS_TWIN_REL = 3e-5


@contextlib.contextmanager
def _three_pass():
    before = ge.F32_MATMUL_3X
    ge.F32_MATMUL_3X = True
    try:
        yield
    finally:
        ge.F32_MATMUL_3X = before


def _one_pass(use, a, b, M, N, K, kw):
    """The control: the product of the bf16-rounded operands."""
    rb = [v._replace(t=v.t.to(torch.bfloat16).float()) for v in a + b]
    return ge.gemm_reference(use, rb[:len(a)], rb[len(a):], M, N, K, **kw)


@pytest.mark.parametrize("name", GEMM_CASES)
def test_gemm_3x_matches_twin_at_main_path_shapes(name):
    use, a, b, M, N, K, kw = gemm_case(name, torch.float32)
    before = (ge.LAUNCHES[use].launches, ge.LAUNCHES[use + ":3x"].launches)
    got = ge.gemm(use, a, b, M, N, K, x3=True, **kw)
    again = ge.gemm(use, a, b, M, N, K, x3=True, **kw)
    want = ge.gemm_reference(use, a, b, M, N, K, x3=True, **kw)
    exact = ge.gemm_reference(use, a, b, M, N, K, **kw)
    torch.cuda.synchronize()
    assert (ge.LAUNCHES[use].launches - before[0],
            ge.LAUNCHES[use + ":3x"].launches - before[1]) == (2, 2)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert _rel_err(got, want) <= GEMM_REL[torch.float32], \
        _rel_err(got, want)
    assert _rel_err(got, exact) <= THREE_PASS_REL, _rel_err(got, exact)
    assert _rel_err(_one_pass(use, a, b, M, N, K, kw), exact) \
        > THREE_PASS_REL


@pytest.mark.parametrize("use", ge.USES)
def test_gemm_3x_small_odd_shapes_match_twin(use):
    """The 3x instance where widths end inside a tile and K inside a
    stage, zero-filled edges splitting to zero."""
    g = torch.Generator("cuda").manual_seed(11)
    M, N, K = 131, 67, 203
    ta, tb = ge.TRANSPOSE[use]
    npairs = 2 if use in ("proj", "dW_in", "dW_rec", "dx") else 1
    a_t = torch.randn(npairs, K if ta else M, M if ta else K, device="cuda",
                      generator=g)
    b_t = torch.randn(npairs, N if tb else K, K if tb else N, device="cuda",
                      generator=g)
    ar, ac = a_t.shape[1:]
    br, bc = b_t.shape[1:]
    shifts = (-3, 3) if use == "dW_rec" else (0, 0)
    a = [View(a_t, p * ar * ac, ac, ar, ac, shifts[p]) for p in range(npairs)]
    b = [View(b_t, p * br * bc, bc, br, bc) for p in range(npairs)]
    kw = {}
    if use == "dx":
        kw["ngroups"] = 2
    elif npairs == 2:
        kw["outputs"] = 2
    if use in ge.SPLIT_USES:
        kw["nsplit"] = 3
    if use == "proj":
        kw.update(bias=torch.randn(2, N, device="cuda", generator=g),
                  bias_mult=0.5)
    got = ge.gemm(use, a, b, M, N, K, x3=True, **kw)
    want = ge.gemm_reference(use, a, b, M, N, K, x3=True, **kw)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= GEMM_REL[torch.float32], \
        _rel_err(got, want)
    with pytest.raises(ValueError, match="float32"):
        ge.gemm(use, a, b, M, N, K, x3=True, compute_dtype=torch.bfloat16,
                **kw)


def test_layer_3x_routes_through_the_3x_engine():
    """A training layer with the switch on: the projection, dW_in,
    dW_rec and dx launch the 3x instance (counted under their uses and as
    3x), and the layer's h and gradients match the 3x twins at K1/K2's
    tolerances."""
    args = make_layer(40, 6, 33, 20, 2, seed=4)
    for c in ge.LAUNCHES.values():
        c.launches = 0
    ts = [a.clone().requires_grad_(True) for a in args[:5]]
    with _three_pass():
        out = lstm_scan_fused(*ts, args[5], 0.7, torch.float32)
        grads = torch.autograd.grad(out, ts, torch.ones_like(out))
    torch.cuda.synchronize()
    n = {u: c.launches for u, c in ge.LAUNCHES.items() if c.launches}
    assert n == {"proj": 1, "dW_in": 1, "dW_rec": 1, "dx": 1,
                 "proj:3x": 1, "dW_in:3x": 1, "dW_rec:3x": 1, "dx:3x": 1}
    cpu = [a.detach().cpu() for a in args]
    h_r, c_r, g_r = lstm_scan_reference(*cpu, 0.7, torch.float32,
                                        save=True, x3=True)
    assert _rel_err(out.cpu(), h_r) <= REL[torch.float32]
    want = lstm_scan_bwd_reference(
        cpu[0], cpu[1], cpu[2], cpu[3], cpu[5], h_r, c_r, g_r,
        torch.ones_like(h_r), 0.7, True, torch.float32, True, x3=True)
    for name, x, y in zip(("dx", "dW_in", "dW_rec", "dpeep", "dbias"),
                          grads, want):
        assert _rel_err(x.cpu(), y) <= REL[torch.float32], name


@pytest.mark.parametrize("shape", [(70, 7, 1001), (1000, 131, 2049),
                                   (600, 300, 2049), (25_000, 250, 10112)])
def test_wide_tail_3x_matches_twin(shape):
    """K4 in 3x mode: the logits and dh in the engine's 3x instance, K4b's
    3x instance (h and dz split into bf16 hi and lo, dW in three wgmma a
    step) against the 3x twins, dz (f32) against the twin's, the first
    tile's rows all dummies, K4b launched twice giving the same bits."""
    h, w, b, tc = _tail(*shape)
    tc[:64] = -1
    f32 = torch.float32
    before = sc.WIDE_BWD_3X.launches
    with _three_pass():
        loss, cnt, a, off, ssum, pt = sc.softmax_ce_wide_fwd(h, w, b, tc,
                                                             0.8, f32)
        g = torch.tensor(0.37, device="cuda")
        dz, dw, db = sc._launch_wide_bwd(a, h, tc, off, ssum, pt, g, 0.8,
                                         x3=True)
        again = sc._launch_wide_bwd(a, h, tc, off, ssum, pt, g, 0.8, x3=True)
        got = sc.softmax_ce_wide_bwd(a, h, w, tc, off, ssum, pt, g, 0.8, f32)
    a_r = sc.wide_logits_reference(h, w, b, 0.8, f32, x3=True)
    want = sc.softmax_ce_wide_bwd_reference(a, h, w, tc, off, ssum, pt, g,
                                            0.8, f32, x3=True)
    exact = sc.softmax_ce_wide_bwd_reference(a, h, w, tc, off, ssum, pt, g,
                                             0.8, f32)
    dz_r = sc.wide_dz_reference(a, tc, off, ssum, pt, g)
    torch.cuda.synchronize()
    assert sc.WIDE_BWD_3X.launches - before == 3
    assert _rel_err(a, a_r) <= GEMM_REL[f32]
    assert all(torch.equal(x, y) for x, y in zip((dz, dw, db), again))
    assert _rel_err(dz, dz_r) <= DZ_REL[f32]
    for name, x, y, z in zip(("dh", "dW", "db"), got, want, exact):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert _rel_err(x, y) <= THREE_PASS_TWIN_REL, (name, _rel_err(x, y))
        assert _rel_err(x, z) <= THREE_PASS_REL, (name, _rel_err(x, z))
    assert not dz[:64].any() and not got[0][:64].any()


# ---------------------------------------- the recurrences' cluster plan
# Every recurrence runs on a cluster of n CTAs, each owning a slice of the
# H cells (ops/lstm_cell.py recurrence_plan). These hold the kernels
# against their twins where the slices are uneven, at the largest cluster,
# on the L2 route, at the streaming width, on an SP block descending and
# with one row, at the tolerances above; every case also launches twice
# and asserts the same bits.
def _tensors(out):
    """The tensors of a kernel's output, nested tuples flattened."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return [] if out is None else [out]


def _same_bits(fn):
    """fn() twice: every output tensor equal bit for bit. Returns the
    first call's outputs."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    for a, b in zip(_tensors(first), _tensors(second), strict=True):
        assert torch.equal(a, b)
    return first


def _train_vs_twins(args, dtype, need_dx=True, seed=1):
    """K1 and K2 against their twins (REL), each launched twice."""
    T, B, _ = args[0].shape
    D, _, G = args[1].shape
    got = _same_bits(lambda: lstm_fwd_save(*args, 0.7, dtype))
    want = lstm_scan_reference(*args, 0.7, dtype, save=True)
    for name, g, w in zip(("h", "c", "gates"), got, want):
        assert torch.isfinite(g.float()).all(), name
        assert _rel_err(g, w) <= REL[dtype], (name, _rel_err(g, w))
    h, c, gates = got
    dh = torch.randn(T, B, D * G // 4, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(seed))
    x, w_in, w_rec, peep, _, lengths = args
    bwd = (x, w_in, w_rec, peep, lengths, h, c, gates, dh, 0.7, True, dtype,
           need_dx)
    got = _same_bits(lambda: lstm_bwd(*bwd))
    want = lstm_scan_bwd_reference(*bwd)
    for name, g, w in zip(("dx", "dW_in", "dW_rec", "dpeep", "dbias"), got,
                          want):
        if g is None:
            continue
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= REL[dtype], (name, _rel_err(g, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(9, 11, 7, 5, 2), (13, 10, 33, 125, 2),
                                   (11, 9, 31, 130, 2)])
def test_cluster_slices_match_twin(shape, dtype):
    """H = 5 (one CTA), 125 (n = 8: slices of 16 and 15) and 130 (n = 9:
    15 and 14): the inference forward, K1 and K2."""
    H = shape[3]
    plan = lstm_cell.recurrence_plan(H, dtype, "fwd")
    assert sum(c for _, c in plan["slices"]) == H
    args = _empty_block(make_layer(*shape, seed=H))
    with torch.inference_mode():
        got = _same_bits(lambda: lstm_scan_fused(*args, 0.7, dtype))
        want = lstm_scan_reference(*args, 0.7, dtype)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    _train_vs_twins(args, dtype)


@pytest.mark.parametrize("H", [300, 512])
def test_cluster_largest_and_l2_route_match_twin(H):
    """f32 at H = 300 (a cluster of 16, W_rec's slice in shared memory)
    and at H = 512 (a cluster of 16, W_rec's slice from L2)."""
    for kind in ("fwd", "bwd"):
        plan = lstm_cell.recurrence_plan(H, torch.float32, kind)
        card = lstm_cell.recurrence_plan_on_card(H, torch.float32, kind)
        assert plan["n"] == card["n"] == 16
        assert plan["w_on_chip"] == card["w_on_chip"] == (H == 300)
        assert (plan["threads"], plan["smem"]) == (card["threads"],
                                                   card["smem"])
    args = _empty_block(make_layer(7, 9, 33, H, 2, seed=H))
    with torch.inference_mode():
        got = _same_bits(lambda: lstm_scan_fused(*args, 0.7))
        want = lstm_scan_reference(*args, 0.7)
    assert (got - want).abs().max().item() <= TOL[torch.float32]
    _train_vs_twins(args, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["gaps", "none"])
def test_cluster_streaming_width_matches_twin(mask_kind, dtype):
    """The carry kernel at the streaming width (H = 250, D = 1, B = 64: a
    cluster of 16), with the step mask and with prefix lengths."""
    args, h0, c0, mask = carry_inputs(64, 64, 250, 250, 1, mask_kind, seed=9)
    with torch.inference_mode():
        got = _same_bits(lambda: lstm_scan_fused_carry(
            *args, h0, c0, 0.7, True, dtype, True, None, 0, mask))
        want = lstm_scan_carry_reference(*args, h0, c0, 0.7, dtype, None, 0,
                                         mask)
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        assert torch.isfinite(g.float()).all()
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_sp_block_descending_matches_twin(dtype):
    """K6b forward and backward on one SP block of a TIMIT layer walked
    descending (dir_offset 1), ragged rows, each launched twice."""
    args, h0, c0, dh, dhf, dcf = _carry_grad_inputs((125, 50, 250, 125, 1),
                                                    11, "ragged")
    got = _same_bits(lambda: lstm_fwd_save_carry(*args, h0, c0, 0.7, dtype,
                                                 None, 1))
    want = lstm_scan_carry_reference(*args, h0, c0, 0.7, dtype, None, 1,
                                     save=True)
    for g, w in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
        assert _rel_err(g, w) <= REL[dtype]
    h, c, gates, _ = got
    x, w_in, w_rec, peep, _, lengths = args
    bwd = (x, w_in, w_rec, peep, lengths, h, c, gates, h0, c0, dh, dhf, dcf,
           0.7, True, dtype, True, None, 1)
    got = _same_bits(lambda: lstm_bwd_carry(*bwd))
    want = lstm_scan_carry_bwd_reference(*bwd)
    for name, g, w in zip(("dx", "dW_in", "dW_rec", "dpeep", "dbias", "dh0",
                           "dc0"), got, want):
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= REL[dtype], (name, _rel_err(g, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_single_row_matches_twin(dtype):
    """B = 1: a cluster whose group holds one row (seven lanes of each
    group idle) in the forward, K1 + K2, and the carry kernels."""
    args = make_layer(9, 1, 7, 125, 2, seed=12)
    with torch.inference_mode():
        got = _same_bits(lambda: lstm_scan_fused(*args, 0.7, dtype))
        want = lstm_scan_reference(*args, 0.7, dtype)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    _train_vs_twins(args, dtype)
    cargs, h0, c0, mask = carry_inputs(9, 1, 7, 125, 1, "gaps", seed=12)
    errs = _carry_errs(cargs, h0, c0, mask, dtype)
    assert max(errs) <= TOL[dtype], errs
    gargs, h0, c0, dh, dhf, dcf = _carry_grad_inputs((9, 1, 7, 125, 1), 12,
                                                     "full")
    h, c, g, _ = lstm_fwd_save_carry(*gargs, h0, c0, 0.7, dtype)
    x, w_in, w_rec, peep, _, lengths = gargs
    bwd = (x, w_in, w_rec, peep, lengths, h, c, g, h0, c0, dh, dhf, dcf, 0.7,
           True, dtype)
    got = _same_bits(lambda: lstm_bwd_carry(*bwd))
    want = lstm_scan_carry_bwd_reference(*bwd)
    for name, a, b in zip(("dx", "dW_in", "dW_rec", "dpeep", "dbias", "dh0",
                           "dc0"), got, want):
        assert _rel_err(a, b) <= REL[dtype], (name, _rel_err(a, b))


def test_sigmoid_reciprocal_is_the_division_bit_for_bit():
    """The recurrences' sigmoids take __frcp_rn(1 + expf(-x)) where they
    took 1 / (1 + expf(-x)): the correctly rounded reciprocal is the
    correctly rounded quotient, bit for bit, over a sweep that crosses
    CURRENNT's saturation at +-88.722839 and the x whose sigmoid is a
    denormal (below -87.33)."""
    lim = 88.722839
    sweep = [torch.linspace(-120.0, 120.0, 2_000_001),
             torch.linspace(-89.5, -86.5, 300_001),
             torch.linspace(86.5, 89.5, 30_001),
             torch.tensor([lim, -lim, 0.0, -0.0, 1e-30, -1e-30, 1e-45])]
    x = torch.cat(sweep).cuda()
    for side in (lim, -lim):  # the neighbours of the saturation points
        v = torch.tensor([side], dtype=torch.float32)
        for _ in range(4):
            x = torch.cat([x, v.cuda()])
            v = torch.nextafter(v, torch.tensor([-200.0]))
    out = lstm_cell.activation_probe(x)
    torch.cuda.synchronize()
    bits = out.view(torch.int32)
    assert torch.equal(bits[0], bits[1])  # plain sigmoid (bf16 mode)
    assert torch.equal(bits[2], bits[3])  # CURRENNT's logistic (f32 mode)
    tiny = out[1][(out[1] > 0) & (out[1] < torch.finfo(torch.float32).tiny)]
    assert tiny.numel() > 1000  # the sweep reached denormal results
    assert (out[2][x >= lim] == 1.0).all() and (out[2][x <= -lim] == 0).all()


# --------------------------------- K3b, dz formed on the chip (PR 11 design)
# K3b at the widths its bodies split at: S in one 64-column chunk, in three
# (the TIMIT tail's 183), at 256 (two dW column blocks, the second one
# chunk), above it and at the route's limit of 704; P one pass of dW and
# two. N ends inside a row tile of either mode.
K3B_WIDTHS = [(S, P) for S in (5, 183, 256, 300, 704) for P in (100, 250)]


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,P", K3B_WIDTHS)
def test_k3b_matches_twin_at_every_width(S, P, dtype):
    """dh, dW and db within the tail's bounds of the twin; dz (the kernel's
    view of it, before rounding) the twin's bit for bit at g = 1 and at g
    = 0.37; a second launch the same bits; dummy rows a zero dh."""
    N = 1037
    h, w, b, tc = _tail(N, P, S, seed=S + P)
    sd = lstm_cell.storage_dtype(dtype)
    _, _, p = softmax_ce_proj_fwd(h, w, b, tc, 0.8, dtype)
    hs, ws = h.to(sd), w.to(sd)
    for gv in (1.0, 0.37):
        g = torch.tensor(gv, device="cuda")
        dz = torch.full((N, S), float("nan"), device="cuda")
        got = _same_bits(lambda: sc._launch_proj_bwd(p, hs, ws, tc, g, 0.8,
                                                     dz_out=dz))
        want = softmax_ce_bwd_reference(p, h, w, tc, g, 0.8, dtype)
        dz_r = sc.plain_dz_reference(p, tc, g)
        torch.cuda.synchronize()
        assert torch.equal(_bits(dz), _bits(dz_r))
        for name, x, y in zip(("dh", "dW", "db"), got, want):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert _rel_err(x, y) <= TAIL_REL[dtype], (name, _rel_err(x, y))
        assert not got[0][tc == -1].any()
    # the check rejects dW with a split's rows left out
    assert _rel_err(want[1] - hs[:64].float().t() @ dz_r[:64].to(sd).float(),
                    want[1]) > TAIL_REL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3b_makes_four_launches(dtype):
    """One K3b call is four kernel launches: the rows' constants and W's
    packing, dh, dW with db, and their partials' sum."""
    from torch.profiler import ProfilerActivity, profile
    h, w, b, tc = _tail(25_000, 250, 183, seed=5)
    sd = lstm_cell.storage_dtype(dtype)
    _, _, p = softmax_ce_proj_fwd(h, w, b, tc, 1.0, dtype)
    g = torch.tensor(1.0, device="cuda")
    args = (p, h.to(sd), w.to(sd), tc, g, 1.0)
    sc._launch_proj_bwd(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            sc._launch_proj_bwd(*args)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")}
    if not kernels:
        pytest.skip("the profiler recorded no device activity")
    assert sum(kernels.values()) <= 4 * 3, kernels
    for part in ("pb_prep_kernel", "pb_dh_", "pb_dw_kernel", "sum_partials"):
        assert any(part in k for k in kernels), (part, kernels)


def test_wide_lstm_layers_take_the_scan_route():
    """On the card, backend "auto" trains a layer of 801 cells per
    direction and serves one of 1,025 through the scan route (no kernel
    launch), with the values of backend "scan"; "pallas" raises."""
    from lstm_rnn_tpu_torch.models.lstm import lstm_forward
    for H, grad in ((801, True), (1025, False)):
        args = make_layer(3, 2, 4, H, 2, seed=H)
        params = {"W_in": args[1].view(2, 4, 4, H),
                  "W_rec": args[2].view(2, H, 4, H),
                  "b": args[4].view(2, 4, H), "peep": args[3]}
        pt = torch.ones(3, 2, dtype=torch.int8, device="cuda")
        outs = []
        for backend in ("auto", "scan"):
            p = {k: v.clone().requires_grad_(grad) for k, v in params.items()}
            before = (lstm_scan_fused.launches, lstm_fwd_save.launches,
                      lstm_bwd.launches)
            with torch.set_grad_enabled(grad):
                y = lstm_forward(p, args[0], pt, 1.0, True, backend=backend)
                if grad:
                    y.sum().backward()
            torch.cuda.synchronize()
            assert (lstm_scan_fused.launches, lstm_fwd_save.launches,
                    lstm_bwd.launches) == before
            outs.append((y, [v.grad for v in p.values()] if grad else []))
        assert torch.equal(outs[0][0], outs[1][0])
        for a, c in zip(outs[0][1], outs[1][1]):
            assert torch.equal(a, c)
        with pytest.raises(ValueError, match="lstm_backend=pallas"), \
                torch.set_grad_enabled(grad):
            lstm_forward({k: v.clone().requires_grad_(grad)
                          for k, v in params.items()}, args[0], pt, 1.0,
                         True, backend="pallas")


def test_wide_softmax_over_wide_layer_takes_k5():
    """A 705-class softmax fed by 1,025 units is past K3's S and K4b's P:
    the fused tail takes the materialized logits and K5 (one launch each
    way), trains, and matches the unfused loss."""
    from lstm_rnn_tpu_torch.network import Network
    net = Network([
        {"name": "input", "type": "input", "size": 5},
        {"name": "l1", "type": "feedforward_tanh", "size": 1025, "bias": 1.0},
        {"name": "output", "type": "softmax", "size": 705, "bias": 1.0},
        {"name": "postoutput", "type": "multiclass_classification",
         "size": 705}])
    net.init_params(3)
    params = net.device_params("cuda")
    for layer in params.values():
        for v in layer.values():
            v.requires_grad_(True)
    g = torch.Generator("cuda").manual_seed(2)
    x = torch.randn(9, 4, 5, device="cuda", generator=g)
    pt = torch.ones(9, 4, dtype=torch.int8, device="cuda")
    tc = torch.randint(0, 705, (9, 4), device="cuda", generator=g,
                       dtype=torch.int32)
    wrappers = (sc.softmax_ce_proj_fwd, sc.softmax_ce_proj_bwd,
                sc.softmax_ce_wide_fwd, sc.softmax_ce_wide_bwd,
                sc.softmax_ce_fwd, sc.softmax_ce_bwd)
    before = [f.launches for f in wrappers]
    loss, _ = net.loss_and_count_fused(params, x, tc, pt)
    loss.backward()
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(wrappers, before)] == [
        0, 0, 0, 0, 1, 1]
    assert torch.isfinite(params["output"]["W"].grad).all()
    with torch.no_grad():
        ref = net.loss(params, x, tc, pt)
    assert loss.item() == pytest.approx(ref.item(), rel=1e-5)


def test_bf16_feedforward_products_on_the_tensor_cores():
    """In bf16 mode the softmax layer's product runs no f32 library GEMM
    (cuBLAS's sgemm, ...f32f32..., ffma) forward or backward, and gives the
    CPU route's values: the forward to f32 sum-order noise, the gradients
    (rounded to bf16 by the operands' casts) to one bf16 ulp of the largest
    entry."""
    from torch.profiler import ProfilerActivity, profile
    from lstm_rnn_tpu_torch.models.feedforward import (feedforward_forward,
                                                       softmax_forward)
    gen = np.random.RandomState(11)
    x0 = torch.tensor(gen.randn(40, 25, 250), dtype=torch.float32)
    w0 = torch.tensor(gen.uniform(-0.1, 0.1, (250, 183)), dtype=torch.float32)
    b0 = torch.tensor(gen.uniform(-0.1, 0.1, 183), dtype=torch.float32)
    dy = torch.tensor(gen.randn(40, 25, 183), dtype=torch.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        x = x0.to(dev).detach().requires_grad_(True)
        params = {"W": w0.to(dev).detach().requires_grad_(True),
                  "b": b0.to(dev)}
        a = feedforward_forward(params, x, "identity", 1.0, torch.bfloat16)
        (a * dy.to(dev)).sum().backward()
        res[dev] = (a.detach().cpu(), x.grad.cpu(), params["W"].grad.cpu())
    for name, got, want, tol in zip(("a", "dx", "dW"), res["cuda"],
                                    res["cpu"], (1e-5, 2.0 ** -7, 2.0 ** -7)):
        assert _rel_err(got, want) <= tol, (name, _rel_err(got, want))
    x = x0.cuda()
    params = {"W": w0.cuda(), "b": b0.cuda()}
    softmax_forward(params, x, 1.0, torch.bfloat16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            softmax_forward(params, x, 1.0, torch.bfloat16)
        xg = x.clone().requires_grad_(True)
        feedforward_forward(params, xg, "identity", 1.0,
                            torch.bfloat16).sum().backward()
        torch.cuda.synchronize()
    keys = [e.key for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not keys:
        pytest.skip("the profiler recorded no device activity")
    f32 = [k for k in keys if any(t in k for t in ("sgemm", "f32f32",
                                                    "ffma"))]
    assert not f32, f32


# ------------------------------------------------- the CHiME recipes' shapes
# Every LSTM layer of the three CHiME recipes (examples/speech_*_chime):
# (P, H per direction, dx): 39 inputs, cells 78, 128, 150 and 51 (clusters
# of 5, 8, 10 and 4 CTAs with uneven slices), the subsampling net's
# feedforward_tanh widths 39 and 75 as the next layer's input. P = 39 is a
# 78-byte bf16 row, only 2-byte aligned.
CHIME_LAYERS = [(39, 78, False), (156, 128, True), (256, 78, True),
                (156, 150, True), (300, 51, True), (39, 150, True),
                (75, 51, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,H,need_dx", CHIME_LAYERS)
def test_chime_layers_match_twins(P, H, need_dx, dtype):
    """K0, K1 and K2 at each CHiME layer's width (T = 90, B = 50, ragged
    rows and an empty block), each launched twice for the same bits."""
    for kind in ("fwd", "bwd"):
        card = lstm_cell.recurrence_plan_on_card(H, dtype, kind)
        plan = lstm_cell.recurrence_plan(H, dtype, kind)
        assert card["n"] == plan["n"] == -(-H // 16)
        assert card["active_clusters"] > 0
    args = _empty_block(make_layer(90, 50, P, H, 2, seed=P + H))
    with torch.inference_mode():
        got = _same_bits(lambda: lstm_scan_fused(*args, 1.0, dtype))
        want = lstm_scan_reference(*args, 1.0, dtype)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    _train_vs_twins(args, dtype, need_dx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chime_tail_matches_twin(dtype):
    """K3f and K3b at the recognition nets' softmax (S = 51 over P = 102:
    below one 64-column wgmma chunk), with dummy frames."""
    h, w, b, tc = _tail(5000, 102, 51, seed=3)
    loss, cnt, p = softmax_ce_proj_fwd(h, w, b, tc, 1.0, dtype)
    loss_r, cnt_r, p_r = softmax_ce_fwd_reference(h, w, b, tc, 1.0, dtype)
    torch.cuda.synchronize()
    assert abs(loss.item() - loss_r.item()) <= 1e-5 * abs(loss_r.item())
    assert abs(cnt.item() - cnt_r.item()) <= 1
    assert _elem_rel(p, p_r) <= P_REL[dtype], _elem_rel(p, p_r)
    g = torch.tensor(1.0, device="cuda")
    got = _same_bits(lambda: softmax_ce_proj_bwd(p, h, w, tc, g, 1.0, dtype))
    want = softmax_ce_bwd_reference(p, h, w, tc, g, 1.0, dtype)
    for name, x, y in zip(("dh", "dW", "db"), got, want):
        assert _rel_err(x, y) <= TAIL_REL[dtype], (name, _rel_err(x, y))


def test_noisy_step_kernel_route_matches_scan_route():
    """One weight-noise SGD step of the CHiME recognition net (f32, T =
    60, B = 8, ragged rows): the kernel route and the scan route from the
    same weights and the same draw give the same loss and update (the
    kernel step taken at the clean weights does not)."""
    import os
    from lstm_rnn_tpu_torch.network import Network
    from lstm_rnn_tpu_torch.trainer import Trainer
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "speech_recognition_chime",
        "no_subsampling", "network.jsn")
    rng = np.random.RandomState(4)
    T, B = 60, 8
    lengths = rng.randint(20, T + 1, B)
    pt = (np.arange(T)[:, None] < lengths[None, :]).astype(np.int8)
    tc = np.where(pt > 0, rng.randint(0, 51, (T, B)), -1).astype(np.int32)
    batch = [torch.from_numpy(a).cuda() for a in (
        rng.randn(T, B, 39).astype(np.float32), tc, pt)]
    out = {}
    for label, backend, sigma in (("kernel", "auto", 0.05),
                                  ("scan", "scan", 0.05),
                                  ("clean", "auto", 0.0)):
        net = Network.from_json_file(path, backend=backend)
        net.init_params(3, dist="normal", normal_sigma=0.1)
        tr = Trainer(net, None, learning_rate=1e-2, momentum=0.9,
                     hybrid_online_batch=True, weight_noise_sigma=sigma,
                     seed=8)
        before = [v.detach().clone() for v in tr._leaves(tr.params)]
        err, _ = tr.train_step(*batch)
        upd = torch.cat([(v.detach() - b).flatten() for v, b in
                         zip(tr._leaves(tr.params), before)])
        out[label] = (err.item(), upd)
    (l_k, u_k), (l_s, u_s) = out["kernel"], out["scan"]
    assert abs(l_k - l_s) <= 1e-5 * abs(l_s)
    assert _rel_err(u_k, u_s) <= 1e-4
    assert _rel_err(out["clean"][1], u_s) > 1e-4


# ---------------------------------------------------------------------------
# data parallelism: each rank runs every training kernel on its block of
# the fraction. The TIMIT recipe's 50 sequences pad to 13 rows a rank on 4
# GPUs (the last rank's 2 rows empty), 25 on 2.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [13, 25])
@pytest.mark.parametrize("P", [117, 250])
def test_per_rank_lstm_kernels_match_twin(P, B, dtype):
    """K0, K1 and K2 at one TIMIT layer's width and one rank's rows, the
    last row empty: the twin's values, and the empty row's h and dx
    exactly zero."""
    T, H, D = 60, 125, 2
    args = list(make_layer(T, B, P, H, D, seed=B + P))
    args[5] = args[5].clone()
    args[5][-1] = 0
    with torch.inference_mode():
        y = lstm_scan_fused(*args, 1.0, dtype)
        y_r = lstm_scan_reference(*args, 1.0, dtype)
    assert (y.float() - y_r.float()).abs().max().item() <= TOL[dtype]
    assert not y[:, -1].any()
    got = lstm_fwd_save(*args, 1.0, dtype)
    want = lstm_scan_reference(*args, 1.0, dtype, save=True)
    for name, g, w in zip(("h", "c", "gates"), got, want):
        assert _rel_err(g, w) <= REL[dtype], (name, _rel_err(g, w))
    h, c, gates = got
    dh = torch.randn(T, B, D * H, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(B)) * 3.0
    x, w_in, w_rec, peep, _, lengths = args
    need_dx = P == 250
    bwd = (x, w_in, w_rec, peep, lengths, h, c, gates, dh, 1.0, True, dtype,
           need_dx)
    got, want = lstm_bwd(*bwd), lstm_scan_bwd_reference(*bwd)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "dW_in", "dW_rec", "dpeep", "dbias"), got,
                          want):
        if g is not None:
            assert torch.isfinite(g).all(), name
            assert _rel_err(g, w) <= REL[dtype], (name, _rel_err(g, w))
    if need_dx:
        assert not got[0][:, -1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [13, 25])
@pytest.mark.parametrize("S", [183, 10112])
def test_per_rank_tails_match_twin(S, B, dtype):
    """K3f/K3b (S = 183) and K4f/K4b (S = 10,112) over one rank's frames
    ([T, B] order, T = 60), the last row's frames dummies: the twins'
    values, and those frames' dh exactly zero."""
    T, P = 60, 250
    h, w, b, tc = _tail(T * B, P, S, seed=B)
    tc[B - 1::B] = -1
    g = torch.tensor(1.0, device="cuda")
    if S == 183:
        loss, cnt, p = softmax_ce_proj_fwd(h, w, b, tc, 1.0, dtype)
        loss_r, cnt_r, p_r = softmax_ce_fwd_reference(h, w, b, tc, 1.0,
                                                      dtype)
        assert _elem_rel(p, p_r) <= P_REL[dtype]
        got = softmax_ce_proj_bwd(p, h, w, tc, g, 1.0, dtype)
        want = softmax_ce_bwd_reference(p, h, w, tc, g, 1.0, dtype)
        rel = TAIL_REL[dtype]
    else:
        loss, cnt, a, off, ssum, pt = sc.softmax_ce_wide_fwd(h, w, b, tc,
                                                             1.0, dtype)
        loss_r, cnt_r, *stats = sc.wide_stats_reference(a, tc)
        for x, y in zip((off, ssum, pt), stats):
            assert _elem_rel(x, y) <= STAT_REL
        got = sc.softmax_ce_wide_bwd(a, h, w, tc, off, ssum, pt, g, 1.0,
                                     dtype)
        want = sc.softmax_ce_wide_bwd_reference(a, h, w, tc, off, ssum, pt,
                                                g, 1.0, dtype)
        rel = WIDE_REL[dtype]
    torch.cuda.synchronize()
    assert abs(loss.item() - loss_r.item()) <= 1e-5 * abs(loss_r.item())
    assert abs(cnt.item() - cnt_r.item()) <= 1
    for name, x, y in zip(("dh", "dW", "db"), got, want):
        assert _rel_err(x, y) <= rel, (name, _rel_err(x, y))
    assert not got[0][B - 1::B].any()


def _dp_net():
    from lstm_rnn_tpu_torch.network import Network
    net = Network([
        {"name": "input", "type": "input", "size": 3},
        {"name": "l1", "type": "blstm", "size": 16, "bias": 1.0},
        {"name": "l2", "type": "blstm", "size": 16, "bias": 1.0},
        {"name": "output", "type": "softmax", "size": 7, "bias": 1.0},
        {"name": "postoutput", "type": "multiclass_classification",
         "size": 7}])
    net.init_params(5)
    return net


def _dp_batch(b):
    """T = 30, b rows (ragged, the last empty), host arrays."""
    rng = np.random.RandomState(7)
    T = 30
    lengths = rng.randint(1, T + 1, b)
    lengths[-1] = 0
    pt = (np.arange(T)[:, None] < lengths[None, :]).astype(np.int8)
    tc = np.where(pt > 0, rng.randint(0, 7, (T, b)), -1).astype(np.int32)
    return rng.randn(T, b, 3).astype(np.float32), tc, pt


def _dp_trainer(group=None, device="cuda", mesh=None):
    from lstm_rnn_tpu_torch.trainer import Trainer
    return Trainer(_dp_net(), None, learning_rate=1e-2, momentum=0.9,
                   hybrid_online_batch=True, data_group=group,
                   seq_mesh=mesh, device=None if group or mesh else device)


def _dp_step_worker(group, out_dir, b):
    """One SGD step of Trainer(data_group=) on this rank's block of the
    padded batch, on its GPU: its loss, count, momentum delta and
    parameters, and its kernel launches."""
    tr = _dp_trainer(group)
    blk = [torch.from_numpy(a).to(group.device)
           for a in group.block(*_dp_batch(b))]
    before = (lstm_fwd_save.launches, lstm_bwd.launches,
              softmax_ce_proj_fwd.launches, softmax_ce_proj_bwd.launches)
    err, corr = tr.train_step(*blk)
    torch.cuda.synchronize()
    after = (lstm_fwd_save.launches, lstm_bwd.launches,
             softmax_ce_proj_fwd.launches, softmax_ce_proj_bwd.launches)
    torch.save({"err": err.item(), "corr": int(corr),
                "v": tr.exact_params(tr.velocity), "w": tr.exact_params(),
                "launches": [x - y for x, y in zip(after, before)]},
               f"{out_dir}/rank{group.rank}.pt")


def _dp_step_matches(tmp_path, devices, backend):
    """The ranks' step against the one-process step on cuda:0 from the
    same weights: losses and counts summed, every rank's momentum delta
    within 1e-6 of the largest (f32 sums split between the ranks), the
    ranks' weights equal, and each rank launched K1 and K2 once a layer
    and K3f and K3b once."""
    from lstm_rnn_tpu_torch.parallel.launch import start
    b = 9
    tr = _dp_trainer()
    err, corr = tr.train_step(*(torch.from_numpy(a).cuda()
                                for a in _dp_batch(b)))
    want_v = tr.exact_params(tr.velocity)
    start(_dp_step_worker, devices, (str(tmp_path), b), backend=backend)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(len(devices))]
    assert abs(sum(r["err"] for r in ranks) - err.item()) <= (
        1e-6 * abs(err.item()))
    assert sum(r["corr"] for r in ranks) == int(corr)
    vmax = max(np.abs(v).max() for layer in want_v.values()
               for v in layer.values())
    for r in ranks:
        assert r["launches"] == [2, 2, 1, 1]
        d = max(np.abs(r["v"][n][k] - want_v[n][k]).max()
                for n in want_v for k in want_v[n])
        assert d <= 1e-6 * vmax, d / vmax
        assert all(np.array_equal(r["w"][n][k], ranks[0]["w"][n][k])
                   for n in want_v for k in want_v[n])


def test_two_rank_gloo_step_on_one_gpu(tmp_path):
    """Two ranks on cuda:0 over gloo through Trainer(data_group=)."""
    _dp_step_matches(tmp_path, [torch.device("cuda", 0)] * 2, "gloo")


def test_nccl_step_on_two_gpus(tmp_path):
    """Two ranks on cuda:0 and cuda:1 over NCCL through
    Trainer(data_group=)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    _dp_step_matches(tmp_path, [torch.device("cuda", j) for j in range(2)],
                     None)


# ---------------------------------------------------------------------------
# DP x SP and data-parallel streaming: a DP x SP rank's block of the TIMIT
# recipe's SP step (B = 25 of 50, T = 250 of 500 over 2 blocks), and a DP
# streaming rank's 32 of the streaming stack's 64 streams.
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dir_offset", [0, 1])
def test_dp_sp_rank_block_matches_twin(dir_offset, dtype, need_dx):
    """K6b forward and backward (rows full, ending inside the block, a
    block of empty rows, a row of length 1) and K6f (prefix lengths) at a
    DP x SP rank's block of a TIMIT layer: the twins' values."""
    test_carry_grad_matches_twin((250, 25, 250, 125, 1), "ragged", None,
                                 dir_offset, dtype, need_dx)
    args, h0, c0, _ = carry_inputs(250, 25, 250, 125, 1, "none", seed=25)
    args[5][4:8] = 0
    errs = _carry_errs(args, h0, c0, None, dtype, None, dir_offset)
    assert max(errs) <= TOL[dtype], errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dir_offset", [0, 1])
def test_dp_sp_all_padding_block_is_zero(dir_offset, dtype):
    """A block whose rows are all padding (no valid frame, zero carries
    and final cotangents; N(0, 1) inputs and output cotangents): every
    output of K6b-f, K6b-b and K6f exactly zero."""
    args = list(make_layer(60, 25, 250, 125, 1, seed=7))
    args[5] = torch.zeros_like(args[5])
    z = torch.zeros(1, 25, 125, device="cuda")
    dh = torch.randn(60, 25, 125, device="cuda")
    h, c, g, (hf, cf) = lstm_fwd_save_carry(*args, z, z, 1.0, dtype, None,
                                            dir_offset)
    x, w_in, w_rec, peep, _, lengths = args
    grads = lstm_bwd_carry(x, w_in, w_rec, peep, lengths, h, c, g, z, z, dh,
                           z, z, 1.0, True, dtype, True, None, dir_offset)
    with torch.inference_mode():
        y, (hf6, cf6) = lstm_scan_fused_carry(*args, z, z, 1.0, True, dtype,
                                              True, None, dir_offset)
    torch.cuda.synchronize()
    for t in (h, c, g, hf, cf, *grads, y, hf6, cf6):
        assert not t.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [117, 250])
def test_dp_stream_rank_matches_twin(P, dtype):
    """K6f+K7 over a 64-frame chunk of a DP streaming rank's 32 streams
    (the streaming stack's LSTM(250)), with a step mask of gaps."""
    args, h0, c0, mask = carry_inputs(64, 32, P, 250, 1, "gaps", seed=P + 1)
    assert max(_carry_errs(args, h0, c0, mask, dtype)) <= TOL[dtype]


def _dpsp_step_worker(group, out_dir, b):
    """One SGD step of Trainer(seq_mesh=, data_group=) on this rank's
    block of the padded batch, on its seq mesh: its loss, count, momentum
    delta and parameters, and its K6b, K1 and K2 launches."""
    tr = _dp_trainer(group, mesh=list(group.seq_mesh))
    blk = [torch.from_numpy(a).to(group.device)
           for a in group.block(*_dp_batch(b))]
    before = (lstm_fwd_save_carry.launches, lstm_bwd_carry.launches,
              lstm_fwd_save.launches, lstm_bwd.launches)
    err, corr = tr.train_step(*blk)
    for dev in set(group.seq_mesh):
        torch.cuda.synchronize(dev)
    after = (lstm_fwd_save_carry.launches, lstm_bwd_carry.launches,
             lstm_fwd_save.launches, lstm_bwd.launches)
    torch.save({"err": err.item(), "corr": int(corr),
                "v": tr.exact_params(tr.velocity), "w": tr.exact_params(),
                "launches": [x - y for x, y in zip(after, before)]},
               f"{out_dir}/rank{group.rank}.pt")


def _dpsp_step_matches(tmp_path, meshes, backend):
    """The ranks' DP x SP step against the one-process step on a 2-block
    mesh of cuda:0 from the same weights: losses and counts summed, every
    rank's momentum delta within 1e-6 of the largest, the ranks' weights
    equal, and each rank launched K6b-f and K6b-b once a layer, direction
    and block (8) and no K1 or K2."""
    from lstm_rnn_tpu_torch.parallel.launch import start
    b = 9
    tr = _dp_trainer(mesh=[torch.device("cuda", 0)] * 2)
    err, corr = tr.train_step(*(torch.from_numpy(a).cuda()
                                for a in _dp_batch(b)))
    want_v = tr.exact_params(tr.velocity)
    start(_dpsp_step_worker, meshes, (str(tmp_path), b), backend=backend)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(len(meshes))]
    assert abs(sum(r["err"] for r in ranks) - err.item()) <= (
        1e-6 * abs(err.item()))
    assert sum(r["corr"] for r in ranks) == int(corr)
    vmax = max(np.abs(v).max() for layer in want_v.values()
               for v in layer.values())
    for r in ranks:
        assert r["launches"] == [8, 8, 0, 0]
        d = max(np.abs(r["v"][n][k] - want_v[n][k]).max()
                for n in want_v for k in want_v[n])
        assert d <= 1e-6 * vmax, d / vmax
        assert all(np.array_equal(r["w"][n][k], ranks[0]["w"][n][k])
                   for n in want_v for k in want_v[n])


def test_two_rank_gloo_dp_sp_step_on_one_gpu(tmp_path):
    """Two DP x SP ranks on cuda:0 over gloo, each a 2-block mesh of
    cuda:0."""
    _dpsp_step_matches(tmp_path, [[torch.device("cuda", 0)] * 2] * 2,
                       "gloo")


def test_nccl_dp_sp_step_on_four_gpus(tmp_path):
    """Two DP x SP ranks over NCCL, rank j on the mesh cuda:2j,
    cuda:2j+1."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four GPUs")
    _dpsp_step_matches(tmp_path, [[torch.device("cuda", 2 * j),
                                   torch.device("cuda", 2 * j + 1)]
                                  for j in range(2)], None)


# ---------------------------------------------- pipeline and tensor (DP x)
def _mesh_trainer(axis, mesh, group=None):
    """_dp_trainer with a pipe or model mesh (and a data group)."""
    from lstm_rnn_tpu_torch.trainer import Trainer
    return Trainer(_dp_net(), None, learning_rate=1e-2, momentum=0.9,
                   hybrid_online_batch=True, data_group=group,
                   **{f"{axis}_mesh": list(mesh)})


# launches of one _dp_net step (2 BLSTM layers, K3 tail) on a pipe mesh of
# m = 2 microbatches: every (stage, microbatch) forward under a
# checkpoint, so K1 and K3f twice per microbatch, K2 and K3b once; on a
# model mesh the LSTM layers run the sharded scan cell, the tail K3 once
MESH_LAUNCHES = {"pipe": [8, 4, 4, 2], "model": [0, 0, 1, 1]}


def _launches():
    return (lstm_fwd_save.launches, lstm_bwd.launches,
            softmax_ce_proj_fwd.launches, softmax_ce_proj_bwd.launches)


def _mesh_step_worker(group, out_dir, b, axis):
    """One SGD step of Trainer(pipe_mesh= or model_mesh=, data_group=) on
    this rank's block, on its mesh: its loss, count, momentum delta,
    parameters and K1, K2, K3f, K3b launches."""
    mesh = getattr(group, f"{axis}_mesh")
    tr = _mesh_trainer(axis, mesh, group)
    blk = [torch.from_numpy(a).to(group.device)
           for a in group.block(*_dp_batch(b))]
    before = _launches()
    err, corr = tr.train_step(*blk)
    for dev in set(mesh):
        torch.cuda.synchronize(dev)
    torch.save({"err": err.item(), "corr": int(corr),
                "v": tr.exact_params(tr.velocity), "w": tr.exact_params(),
                "launches": [x - y for x, y in zip(_launches(), before)]},
               f"{out_dir}/rank{group.rank}.pt")


def _mesh_step_matches(tmp_path, axis, meshes, backend):
    """The ranks' DP x PP or DP x TP step against the one-process step on
    a 2-device mesh of cuda:0 of the same kind, from the same weights:
    losses and counts summed, every rank's momentum delta within 1e-6 of
    the largest, the ranks' weights equal, each rank's exact launches."""
    from lstm_rnn_tpu_torch.parallel.launch import start
    b = 9
    tr = _mesh_trainer(axis, [torch.device("cuda", 0)] * 2)
    err, corr = tr.train_step(*(torch.from_numpy(a).cuda()
                                for a in _dp_batch(b)))
    want_v = tr.exact_params(tr.velocity)
    start(_mesh_step_worker, meshes, (str(tmp_path), b, axis),
          backend=backend, axis=axis)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(len(meshes))]
    assert abs(sum(r["err"] for r in ranks) - err.item()) <= (
        1e-6 * abs(err.item()))
    assert sum(r["corr"] for r in ranks) == int(corr)
    vmax = max(np.abs(v).max() for layer in want_v.values()
               for v in layer.values())
    for r in ranks:
        assert r["launches"] == MESH_LAUNCHES[axis]
        d = max(np.abs(r["v"][n][k] - want_v[n][k]).max()
                for n in want_v for k in want_v[n])
        assert d <= 1e-6 * vmax, d / vmax
        assert all(np.array_equal(r["w"][n][k], ranks[0]["w"][n][k])
                   for n in want_v for k in want_v[n])


@pytest.mark.parametrize("axis", ["pipe", "model"])
def test_mesh_step_matches_one_gpu(axis):
    """A pipelined (2 stages, 2 microbatches) and a tensor-parallel (2
    shards) step on a mesh of cuda:0 twice against the one-device kernel
    step from the same weights: the loss (1e-5 relative) and every
    momentum delta (1e-4 of the largest; the TP layers run the scan cell,
    the pipeline the same kernels over half the rows), the exact
    launches."""
    b = 9
    batch = [torch.from_numpy(a).cuda() for a in _dp_batch(b)]
    one = _dp_trainer()
    err1, corr1 = one.train_step(*batch)
    tr = _mesh_trainer(axis, [torch.device("cuda", 0)] * 2)
    before = _launches()
    err, corr = tr.train_step(*batch)
    torch.cuda.synchronize()
    assert [x - y for x, y in zip(_launches(), before)] == \
        MESH_LAUNCHES[axis]
    assert abs(err.item() - err1.item()) <= 1e-5 * abs(err1.item())
    assert int(corr) == int(corr1)
    want, got = one.exact_params(one.velocity), tr.exact_params(tr.velocity)
    vmax = max(np.abs(v).max() for layer in want.values()
               for v in layer.values())
    d = max(np.abs(got[n][k] - want[n][k]).max() for n in want
            for k in want[n])
    assert d <= 1e-4 * vmax, d / vmax


@pytest.mark.parametrize("axis", ["pipe", "model"])
def test_two_rank_gloo_mesh_step_on_one_gpu(tmp_path, axis):
    """Two DP x PP or DP x TP ranks on cuda:0 over gloo, each a 2-device
    mesh of cuda:0."""
    _mesh_step_matches(tmp_path, axis, [[torch.device("cuda", 0)] * 2] * 2,
                       "gloo")


@pytest.mark.parametrize("axis", ["pipe", "model"])
def test_nccl_mesh_step_on_four_gpus(tmp_path, axis):
    """Two DP x PP or DP x TP ranks over NCCL, rank j on the mesh
    cuda:2j, cuda:2j+1."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four GPUs")
    _mesh_step_matches(tmp_path, axis, [[torch.device("cuda", 2 * j),
                                         torch.device("cuda", 2 * j + 1)]
                                        for j in range(2)], None)


# --------------------------------------------------------------- data feed
def _feed_trainer(tmp_path, **kw):
    """Trainer over a small corpus made from a seed (3 inputs, 24 train and
    8 val sequences of 5-40 frames in two length buckets, 4 a fraction,
    shuffled fractions), the _dp_net on cuda:0, 2 epochs, stochastic."""
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.data.netcdf3 import strings_to_chars, write_netcdf
    from lstm_rnn_tpu_torch.trainer import Trainer
    rng = np.random.RandomState(3)
    sets = []
    for name, n in (("train", 24), ("val", 8)):
        lengths = rng.randint(5, 41, n)
        total = int(lengths.sum())
        path = str(tmp_path / f"{name}.nc")
        write_netcdf(path, {"numSeqs": n, "numTimesteps": total,
                            "inputPattSize": 3, "numLabels": 7,
                            "maxSeqTagLength": 8}, [
            ("seqTags", ["numSeqs", "maxSeqTagLength"],
             strings_to_chars([f"s{i}" for i in range(n)], 8)),
            ("seqLengths", ["numSeqs"], lengths.astype(np.int32)),
            ("inputs", ["numTimesteps", "inputPattSize"],
             rng.randn(total, 3).astype(np.float32)),
            ("targetClasses", ["numTimesteps"],
             rng.randint(0, 7, total).astype(np.int32))])
        sets.append(DataSet([path], parallel_sequences=4,
                            sort_by_length=True, fraction_shuffling=True,
                            seed=3, bucket_lengths=(24, 48)))
    kw = {"hybrid_online_batch": True, **kw}
    return Trainer(_dp_net(), *sets, learning_rate=1e-2, momentum=0.9,
                   max_epochs=2, device="cuda", **kw)


def _feed_run(t):
    rows = []
    while True:
        done = t.train_epoch()
        rows.append((t.cur_training_error, t.cur_validation_error))
        if done:
            return rows, t.exact_params()


@pytest.mark.parametrize("hybrid", [True, False],
                         ids=["stochastic", "batch"])
def test_cached_epochs_match_on_the_card(tmp_path, hybrid):
    """Cached epochs run the same kernels on the same inputs as the plain
    run: its errors and weights bit for bit; epoch 2 copies no byte from
    the host (train and val passes); the pinned buffers are reused."""
    rows, params = _feed_run(_feed_trainer(tmp_path,
                                           hybrid_online_batch=hybrid))
    t = _feed_trainer(tmp_path, hybrid_online_batch=hybrid,
                      device_cache=True)
    got_rows, got = _feed_run(t)
    assert got_rows == rows
    for n in params:
        for k in params[n]:
            np.testing.assert_array_equal(got[n][k], params[n][k])
    assert t.h2d_bytes[0] > 0 and t.h2d_bytes[2:] == [0, 0]
    assert t.device_cache_stats()["misses"] == 0
    assert t._staging.allocations <= 2 * t._staging.SLOTS


def test_staging_never_rewrites_a_copy_in_flight():
    """The pinned staging buffers are reused round robin while the stream
    is busy: every copy still lands with its own bytes (a buffer is
    written again only after its last copy's event), two allocations."""
    from lstm_rnn_tpu_torch.trainer import _Staging
    st = _Staging(torch.device("cuda"))
    a = torch.randn(2048, 2048, device="cuda")
    outs = []
    for i in range(8):
        for _ in range(4):  # queue work ahead of the copy
            a = torch.tanh(a @ a)
        outs.append(st.to_device(1 << 20, lambda buf, i=i: buf.fill(i)))
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert out.device.type == "cuda" and bool((out == i).all()), i
    assert st.allocations == st.SLOTS


# ---------------------------------------------------- step graphs (graphs.py)
def _graph_net(dtype, remat):
    """A TIMIT-shaped net cut in depth: 117 inputs, 2 BLSTM(250) (125
    cells a direction), softmax(183)."""
    from lstm_rnn_tpu_torch.network import Network
    net = Network([{"name": "input", "type": "input", "size": 117},
                   {"name": "l1", "type": "blstm", "size": 250, "bias": 1.0},
                   {"name": "l2", "type": "blstm", "size": 250, "bias": 1.0},
                   {"name": "output", "type": "softmax", "size": 183,
                    "bias": 1.0},
                   {"name": "postoutput", "type": "multiclass_classification",
                    "size": 183}],
                  compute_dtype="bfloat16" if dtype == "bf16" else "float32")
    net.init_params(7)
    net.remat_blocks = 4 if remat else 0
    return net


def _graph_fractions(n, T=60, B=16):
    """n fractions of [T, B] (ragged rows) on the card."""
    rng = np.random.RandomState(11)
    out = []
    for _ in range(n):
        lengths = rng.randint(1, T + 1, B)
        pt = (np.arange(T)[:, None] < lengths[None, :]).astype(np.int8)
        tc = np.where(pt > 0, rng.randint(0, 183, (T, B)), -1).astype(
            np.int32)
        out.append(tuple(torch.from_numpy(a).cuda() for a in (
            rng.randn(T, B, 117).astype(np.float32), tc, pt)))
    return out


def _graph_trainer(dtype, remat):
    from lstm_rnn_tpu_torch.trainer import Trainer
    return Trainer(_graph_net(dtype, remat), None, learning_rate=1e-3,
                   momentum=0.9, hybrid_online_batch=True, device="cuda",
                   fuse_fractions=4)


@pytest.mark.parametrize("dtype, remat", [("f32", False), ("bf16", False),
                                          ("f32", True)],
                         ids=["f32", "bf16", "remat"])
def test_step_graph_replay_matches_eager(dtype, remat):
    """Four training steps and two evaluation steps through the step
    graphs (warm-up, capture and replays) against the same steps eager:
    the losses, counts and weights bit for bit, one capture a mode,
    replays = steps - warm-ups, and the launches that ran (the wrappers'
    counts with each capture's counted once a replay) equal."""
    from lstm_rnn_tpu_torch.graphs import launch_counters
    fracs = _graph_fractions(4)
    runs = []
    for fused in (False, True):
        tr = _graph_trainer(dtype, remat)
        before = {k: c.launches for k, c in launch_counters().items()}
        out = []
        for f in fracs:
            out.append(tr._fused_step(f, True) if fused else tr.train_step(*f))
        for f in fracs[:2]:
            out.append(tr._fused_step(f, False) if fused
                       else tr.eval_step(*f))
        torch.cuda.synchronize()
        counts = {k: c.launches - before[k]
                  for k, c in launch_counters().items()}
        runs.append(([(e.item(), int(c)) for e, c in out],
                     tr.exact_params(), counts, tr.graph_stats))
    (eager, p_eager, n_eager, _), (graph, p_graph, n_graph, stats) = runs
    assert graph == eager
    for n in p_eager:
        for k in p_eager[n]:
            np.testing.assert_array_equal(p_graph[n][k], p_eager[n][k],
                                          err_msg=f"{n}/{k}")
    tail = "softmax_ce_fwd" if remat else "softmax_ce_proj_fwd"
    # the wrappers saw each graph's kernels once, at its capture: 4 of
    # the 6 steps called them
    assert n_eager[tail] == 6 and n_graph[tail] == 4
    assert {k: stats.executed(k, n) for k, n in n_graph.items()} == n_eager
    st = stats.as_dict()
    assert (st["warmups"], st["captures"], st["replays"]) == (2, 2, 4)
    assert all(b > 0 for b in st["pool_bytes"])


def test_step_graph_stale_buffers_change_the_loss():
    """The control: a replay whose static buffers still hold the last
    fraction gives another loss than the eager step on the next one, so
    the replay's comparison above can fail; with the next fraction
    copied in, it gives the eager step's loss."""
    fracs = _graph_fractions(3)
    tr = _graph_trainer("f32", False)
    for f in fracs[:2]:
        tr._fused_step(f, False)  # warm-up, then capture and replay
    graph = next(iter(tr._graphs.values()))
    want = tr.eval_step(*fracs[2])[0].item()
    graph.graph.replay()  # fracs[1] still in the static buffers
    stale = graph.out[0].item()
    got = tr._fused_step(fracs[2], False)[0].item()
    assert got == want
    assert stale != want
    assert stale == tr.eval_step(*fracs[1])[0].item()


def test_step_graph_that_does_not_fit_runs_eagerly(capsys):
    """A shape whose capture would not fit in free memory (its warm-up's
    need on its GPU set past the card's memory) steps eagerly, with the
    eager step's values, captures nothing, and the Trainer names it
    once."""
    fracs = _graph_fractions(4)
    want = _graph_trainer("f32", False)
    want_out = [want.train_step(*f)[0].item() for f in fracs]
    tr = _graph_trainer("f32", False)
    got = [tr._fused_step(fracs[0], True)[0].item()]
    graph = next(iter(tr._graphs.values()))
    graph.needs[graph.device] = 1 << 50
    got += [tr._fused_step(f, True)[0].item() for f in fracs[1:]]
    assert got == want_out
    st = tr.graph_stats.as_dict()
    assert (st["warmups"], st["captures"], st["replays"], st["eager"]) == (
        1, 0, 0, 3)
    assert capsys.readouterr().out.count("it runs eagerly") == 1


def _fused_against_eager(make, fracs, fuse_steps=True):
    """The same training and evaluation steps through a fresh Trainer's
    step graphs and eagerly: ((losses, counts), parameters, GraphStats)
    of each, and the collectives each issued (the graphs' counted once a
    replay)."""
    from lstm_rnn_tpu_torch.parallel.data import all_reduce_sum
    runs = []
    for fused in (False, True):
        tr = make()
        before = all_reduce_sum.collectives
        out = [tr._fused_step(f, True) if fused else tr.train_step(*f)
               for f in fracs]
        out += [tr._fused_step(f, False) if fused else tr.eval_step(*f)
                for f in fracs[:2]]
        torch.cuda.synchronize()
        issued = tr.graph_stats.executed(
            "collectives", all_reduce_sum.collectives - before)
        runs.append(([(e.item(), int(c)) for e, c in out],
                     tr.exact_params(), tr.graph_stats, issued))
        tr.drop_graphs()
    return runs


def test_step_graph_holds_a_one_rank_nccl_all_reduce():
    """A data group of one rank over NCCL on cuda:0: the training step's
    graph holds the packed all-reduce; four training and two evaluation
    steps through the graphs equal the same steps eagerly bit for bit,
    and each training step issued one collective, its replays counted."""
    import torch.distributed as dist

    from lstm_rnn_tpu_torch.parallel.data import DataGroup
    from lstm_rnn_tpu_torch.trainer import Trainer
    # as parallel/launch.py's workers join: the communicator comes at the
    # first collective, the warm-up step's
    torch.cuda.set_device(0)
    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        group = DataGroup(0, 1, torch.device("cuda", 0))
        fracs = _graph_fractions(4)

        def make():
            return Trainer(_graph_net("f32", False), None,
                           learning_rate=1e-3, momentum=0.9,
                           hybrid_online_batch=True, data_group=group,
                           fuse_fractions=4)

        (eager, p_eager, _, n_eager), (graph, p_graph, stats, n_graph) = \
            _fused_against_eager(make, fracs)
    finally:
        dist.destroy_process_group()
    assert graph == eager
    for n in p_eager:
        for k in p_eager[n]:
            np.testing.assert_array_equal(p_graph[n][k], p_eager[n][k],
                                          err_msg=f"{n}/{k}")
    assert n_eager == n_graph == 4
    st = stats.as_dict()
    assert (st["warmups"], st["captures"], st["replays"]) == (2, 2, 4)
    assert st["launches"][0]["collectives"] == 1
    assert "collectives" not in st["launches"][1]  # the eval graph


@pytest.mark.parametrize("axis", ["seq", "pipe"])
def test_step_graph_spans_a_two_gpu_mesh(axis):
    """A seq mesh (2 time blocks) and a pipe mesh (2 stages, 2
    microbatches) over cuda:0 and cuda:1: the step graph spans both GPUs,
    and four training and two evaluation steps through it equal the same
    steps eagerly on the mesh bit for bit; the pools of both GPUs count."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 GPUs")
    from lstm_rnn_tpu_torch.trainer import Trainer
    mesh = [torch.device("cuda", 0), torch.device("cuda", 1)]
    fracs = _graph_fractions(4)

    def make():
        return Trainer(_graph_net("f32", False), None, learning_rate=1e-3,
                       momentum=0.9, hybrid_online_batch=True,
                       fuse_fractions=4, **{f"{axis}_mesh": mesh})

    (eager, p_eager, _, _), (graph, p_graph, stats, _) = \
        _fused_against_eager(make, fracs)
    assert graph == eager
    for n in p_eager:
        for k in p_eager[n]:
            np.testing.assert_array_equal(p_graph[n][k], p_eager[n][k],
                                          err_msg=f"{n}/{k}")
    st = stats.as_dict()
    assert (st["warmups"], st["captures"], st["replays"], st["eager"]) == (
        2, 2, 4, 0)


# ---------------------------------------------- tensor parallelism (K8)
# K8f and K8b against their twins (ops/lstm_tp.py): the kernels sum
# h . W_rec and the BPTT's partials in another order than the twins'
# bmm, carried over the steps; relative to the largest entry, the
# bounds chip_smoke holds a TP step's loss and gradients to
# (TP_STEP_TOL)
TP_TOL = {"fwd": 1e-5, "bwd": 1e-4}


def _tp_case(H, mesh, T, B=50, P=117, seed=3):
    """A bidirectional layer of H cells a direction over the model mesh
    `mesh`: the K8 operands (parallel/tensor.py `_operands`) of ragged
    rows, one with a gap of 5 invalid frames inside it, and an output
    cotangent [T, D, B, w] a shard in scan order."""
    from lstm_rnn_tpu_torch.parallel.tensor import _operands
    rng = np.random.RandomState(seed)
    params = {k: torch.from_numpy(rng.uniform(-0.1, 0.1, s).astype(
        np.float32)).to(mesh[0]) for k, s in (
            ("W_in", (2, P, 4, H)), ("W_rec", (2, H, 4, H)),
            ("b", (2, 4, H)), ("peep", (2, 3, H)))}
    x = torch.from_numpy(rng.randn(T, B, P).astype(np.float32)).to(mesh[0])
    lengths = rng.randint(T // 2, T + 1, B)
    lengths[0] = T
    pt = (np.arange(T)[:, None] < lengths[None, :]).astype(np.int8)
    pt[T // 3:T // 3 + 5, 0] = 0
    acts, w_recs, peeps, masks, _ = _operands(
        params, x, torch.from_numpy(pt).to(mesh[0]), 1.0, True, mesh)
    w = H // len(mesh)
    dys = [torch.from_numpy(rng.randn(T, 2, B, w).astype(np.float32)).to(d)
           for d in mesh]
    return acts, w_recs, peeps, masks, dys


def _tp_rel(got, want):
    return max(float((g.to(w.device) - w).abs().max()) for g, w in
               zip(got, want)) / max(float(w.abs().max()) for w in want)


@pytest.mark.parametrize("H, n, gpus, T", [(125, 5, 1, 200),
                                           (1024, 4, 4, 60)],
                         ids=["tp_125x5_on_one_gpu", "tp_1024x4_on_4_gpus"])
def test_tp_kernels_match_twins(H, n, gpus, T):
    """K8f (with its residuals) and K8b against their twins: TIMIT's 125
    cells in 5 shards on cuda:0 (one launch covers all five), and 1,024
    cells in 4 shards on 4 GPUs (W_rec read from L2; peer stores over
    NVLink). Every replica of the output is the same bit for bit; one
    launch of each kernel a GPU."""
    from lstm_rnn_tpu_torch.ops import lstm_tp
    if torch.cuda.device_count() < gpus:
        pytest.skip(f"needs {gpus} GPUs")
    mesh = [torch.device("cuda", i % gpus) for i in range(n)]
    acts, w_recs, peeps, masks, dys = _tp_case(H, mesh, T)
    f0, b0 = lstm_tp.lstm_tp_fwd.launches, lstm_tp.lstm_tp_bwd.launches
    ys, cs, gs = lstm_tp.lstm_tp_fwd(mesh, acts, w_recs, peeps, masks, True)
    da = lstm_tp.lstm_tp_bwd(mesh, gs, cs, w_recs, peeps, dys, masks)
    for d in range(gpus):
        torch.cuda.synchronize(d)
    lstm_tp.check(mesh)
    assert (lstm_tp.lstm_tp_fwd.launches - f0,
            lstm_tp.lstm_tp_bwd.launches - b0) == (gpus, gpus)
    assert len(ys) == gpus
    assert all(torch.equal(y.cpu(), ys[0].cpu()) for y in ys)
    yt, ct, gt = lstm_tp.lstm_tp_fwd_reference(acts, w_recs, peeps, masks,
                                               mesh, save=True)
    assert _tp_rel(ys, yt) <= TP_TOL["fwd"]
    assert _tp_rel(cs, ct) <= TP_TOL["fwd"]
    assert _tp_rel(gs, gt) <= TP_TOL["fwd"]
    # K8b from the kernel's residuals against its twin from the same
    dat = lstm_tp.lstm_tp_bptt_reference(gs, cs, w_recs, peeps, dys, masks,
                                         mesh)
    assert _tp_rel(da, dat) <= TP_TOL["bwd"]
    # the control: the twin from a cotangent with one entry changed
    dys2 = [d.clone() for d in dys]
    dys2[0][T // 2] += 1.0
    bad = lstm_tp.lstm_tp_bptt_reference(gs, cs, w_recs, peeps, dys2, masks,
                                         mesh)
    assert _tp_rel(da, bad) > TP_TOL["bwd"]


def test_tp_step_graph_replays_bit_for_bit():
    """The TIMIT-shaped net's training step with its LSTM layers in 5
    shards on cuda:0, through its step graph: 52 steps (a warm-up, then
    a capture and 51 replays) against the same 52 steps eager, the losses,
    counts and weights bit for bit; each replay ran K8f and K8b once a
    layer (GraphStats.executed)."""
    from lstm_rnn_tpu_torch.ops import lstm_tp
    from lstm_rnn_tpu_torch.trainer import Trainer
    fracs = _graph_fractions(52, T=40)
    mesh = [torch.device("cuda", 0)] * 5
    runs = []
    for fused in (False, True):
        tr = Trainer(_graph_net("f32", False), None, learning_rate=1e-3,
                     momentum=0.9, hybrid_online_batch=True,
                     model_mesh=mesh, fuse_fractions=4)
        f0, b0 = lstm_tp.lstm_tp_fwd.launches, lstm_tp.lstm_tp_bwd.launches
        out = [tr._fused_step(f, True) if fused else tr.train_step(*f)
               for f in fracs]
        torch.cuda.synchronize()
        lstm_tp.check(mesh)
        ran = (tr.graph_stats.executed(
                   "lstm_tp_fwd", lstm_tp.lstm_tp_fwd.launches - f0),
               tr.graph_stats.executed(
                   "lstm_tp_bwd", lstm_tp.lstm_tp_bwd.launches - b0))
        runs.append(([(e.item(), int(c)) for e, c in out],
                     tr.exact_params(), tr.graph_stats.as_dict(), ran))
    (eager, p_eager, _, n_eager), (graph, p_graph, st, n_graph) = runs
    assert graph == eager
    for n in p_eager:
        for k in p_eager[n]:
            np.testing.assert_array_equal(p_graph[n][k], p_eager[n][k],
                                          err_msg=f"{n}/{k}")
    assert (st["warmups"], st["captures"], st["replays"]) == (1, 1, 51)
    assert n_eager == n_graph == (2 * 52, 2 * 52)


def test_tp_wait_past_its_bound_raises():
    """A K8f launch holding shard 0 of a 2-shard mesh with no launch for
    shard 1: its waits for shard 1's steps run into the bound (0.2 s
    here), the launch ends, and the mesh's check raises naming the layer
    and the GPU, within seconds instead of hanging."""
    import ctypes
    import time

    from lstm_rnn_tpu_torch.ops import _build, lstm_tp
    mesh = [torch.device("cuda", 0)] * 2
    acts, w_recs, peeps, masks, _ = _tp_case(32, mesh, 20, B=8, P=5)
    ctx = lstm_tp.MeshContext(mesh)  # its own, not the registered one
    ys = [torch.empty((20, 8, 64), device="cuda")]
    t0 = time.perf_counter()
    err = lstm_tp._launch_fwd_on(
        _build.load(), ctx, 0, [0], acts, w_recs, peeps, None, None, masks,
        ys, ctx.layer_id("l1"), 0.2,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 < 10
    with pytest.raises(RuntimeError, match="l1 on cuda:0 waited past"):
        ctx.check()
