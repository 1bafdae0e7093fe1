"""The Hopper LSTM kernel (csrc/lstm_fwd.cu) against its plain twin, on the
card: small and full TIMIT width, float32 and bfloat16 modes, and the
wrapper's refusals.

Needs a CUDA GPU and nvcc: every test carries the `cuda` marker and skips
without a GPU (an autouse fixture decides at run time, so every worker
collects the same tests). The machine with the card has no jax, so run
this file there without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from lstm_rnn_tpu_torch.ops import lstm_cell
from lstm_rnn_tpu_torch.ops.lstm_cell import (lstm_scan_fused,
                                              lstm_scan_reference)

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
