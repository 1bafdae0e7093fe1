"""lstm_rnn_tpu_torch — the PyTorch + CUDA port of lstm_rnn_tpu.

The same CURRENNT-compatible network JSON, NetCDF data, flag surface and
numerics as the JAX package, running on an NVIDIA Hopper GPU. The LSTM
recurrence runs in a CUDA kernel written for sm_90a (csrc/lstm_fwd.cu);
everything else is plain PyTorch. This package imports torch and numpy
only — never jax and never lstm_rnn_tpu.

This slice ports the forward-pass (posterior dump) mode; training follows
(ROADMAP.md).
"""

__version__ = "0.1.0"

from lstm_rnn_tpu_torch.network import Network  # noqa: F401
