"""lstm_rnn_tpu_torch — the PyTorch + CUDA port of lstm_rnn_tpu.

The same CURRENNT-compatible network JSON, NetCDF data, flag surface and
numerics as the JAX package, running on an NVIDIA Hopper GPU. The LSTM
layers (forward and BPTT) and the fused softmax + cross-entropy tail run in
CUDA kernels written for sm_90a (csrc/); everything else is plain PyTorch.
This package imports torch and numpy only — never jax and never
lstm_rnn_tpu.

Ported: the forward-pass (posterior dump) mode, streaming serving,
training (weight noise, input noise and --init_rng currennt included),
sequence parallelism in one process and data parallelism over processes,
on one host or several (`parallel/`), and the data feed: pinned
non-blocking copies, the device cache and the native JSON formatter
(`runtime/`); the rest follows (ROADMAP.md).
"""

__version__ = "0.1.0"

from lstm_rnn_tpu_torch.network import Network  # noqa: F401
