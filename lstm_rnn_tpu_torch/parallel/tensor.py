"""Tensor parallelism: an LSTM layer with its cells sharded over a model
mesh.

Counterpart of lstm_rnn_tpu/parallel/tensor.py (`shard_lstm_params`,
`lstm_forward_tp`). Device i of the mesh (an ordered list of devices,
parallel/mesh.py) owns H/n cells per direction: their input-projection
and recurrent weight columns, bias, peepholes and cell state. It
computes its cells' gates from the FULL previous output, which every
device holds again after each step. The semantics are `lstm_forward`'s
scan route, from the same cell code (`ops/lstm_cell.py`
`lstm_cell_step`: the CURRENNT cell, the +-1 delta clip and the split
og-peephole path).

Where the JAX package runs shard_map with an all_gather over ICI inside a
`lax.scan`, the port uses plain tensors on the mesh's devices, driven from
one process:
- the parameters live once, on mesh[0] (the Trainer's device); each
  device takes a differentiable copy of its columns (`shard_lstm_params`:
  a slice, then `.to(mesh[i])`, a no-op when the device repeats), so
  autograd assembles the full gradients on mesh[0];
- the exchange is the all_gather: after every step each device's new
  h slice is copied to every device and concatenated there, so every
  device holds that step's full h. Autograd's backward of those copies
  sums the cotangents of every device's use of h, the reduce_scatter;
- every device stacks the full h of every step, so the layer's output is
  already on each device: the next tensor-parallel layer's input
  projection reads it where it lies, with no second copy (the function
  returns one replica per device, mesh[0]'s first).

Per step the host issues, on each of the n devices, the recurrent
product, the cell's element-wise operations and the masks, plus n x n
copies and n concatenations for the exchange: a host-driven step whose
cost grows with n, which is what a tensor-parallel layer costs.

This is not a fallback from a kernel to its twin. JAX's tensor-parallel
path is a `lax.scan` of the cell with no `pallas_call`
(lstm_rnn_tpu/parallel/tensor.py:86-113), so it has no TPU kernel to
port, and this loop is the port's counterpart of that scan, not a kernel
twin standing in for a kernel. On the card it runs in the same
operations, so a tensor-parallel layer launches none of the recurrence
kernels K0-K2; the tail kernels still run after it.

Numerics, as the JAX function's: it takes no compute dtype. The products
run in the weights' dtype (f32, true f32 with TF32 off), and h is never
rounded to bf16, so under --compute_dtype bfloat16 the tensor-parallel
layers compute in f32 (lstm_rnn_tpu/network.py:254-257). The activations
are the CURRENNT forms (logistic, tanh = 2 sigma(2x) - 1), as in JAX's
`lstm_cell_step`.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from lstm_rnn_tpu_torch.ops.activations import grad_clip
from lstm_rnn_tpu_torch.ops.lstm_cell import lstm_cell_step


def shard_lstm_params(mesh: Sequence[torch.device], params) -> List[dict]:
    """One LSTM layer's parameters as n shards, shard i on mesh[i] with
    cells [i H/n, (i+1) H/n) of each direction: W_in [D, P, 4, H/n],
    W_rec [D, H, 4, H/n] (every row: the full h feeds the owned columns),
    b [D, 4, H/n] and peep [D, 3, H/n]. Differentiable copies of the
    tensors given, wherever they lie."""
    n = len(mesh)
    h = params["W_in"].shape[-1]
    if h % n:
        raise ValueError(f"hidden size {h} must divide the 'model' axis "
                         f"({n})")
    w = h // n
    return [{k: v[..., i * w:(i + 1) * w].to(dev) for k, v in params.items()}
            for i, dev in enumerate(mesh)]


def lstm_forward_tp(params, x, pattypes, bias_mult: float,
                    bidirectional: bool, mesh: Sequence[torch.device],
                    clip_gradients: bool = True) -> List[torch.Tensor]:
    """Tensor-parallel counterpart of `lstm_forward`'s scan route.

    params: one layer's tree (W_in [D, P, 4, H], ...), H divisible by the
    mesh's length; x: [T, B, P], or a list of it on every device of the
    mesh (the previous tensor-parallel layer's replicas); pattypes [T, B]
    on mesh[0]. Returns the layer's output [T, B, L] ([fw | bw] per
    frame, in x's dtype) on every device of the mesh, mesh[0]'s first."""
    mesh = list(mesh)
    n = len(mesh)
    d = params["W_in"].shape[0]
    if d != (2 if bidirectional else 1):
        raise ValueError(f"W_in has {d} directions; bidirectional="
                         f"{bidirectional}")
    gclip = grad_clip if clip_gradients else None
    shards = shard_lstm_params(mesh, params)
    xs = list(x) if isinstance(x, (list, tuple)) else [x.to(dev)
                                                       for dev in mesh]
    dtype = xs[0].dtype
    T, B, _ = xs[0].shape
    valid = (pattypes != 0).to(dtype)[:, None, :, None]  # [T, 1, B, 1]
    mask = torch.cat([valid, valid.flip(0)], dim=1) if bidirectional \
        else valid
    masks = [mask.to(dev) for dev in mesh]

    acts, w_recs = [], []
    for sh, xi in zip(shards, xs):
        _, P, _, w = sh["W_in"].shape
        # my cells' projections over all T at once (JAX's einsum outside
        # the scan), natural order for d = 0, reversed for d = 1
        a = torch.matmul(xi.reshape(T * B, P), sh["W_in"].reshape(d, P,
                                                                  4 * w))
        a = a.view(d, T, B, 4, w).permute(1, 0, 2, 3, 4)
        a = a + bias_mult * sh["b"][None, :, None]
        if bidirectional:
            a = torch.cat([a[:, 0:1], a.flip(0)[:, 1:2]], dim=1)
        acts.append(a)
        w_recs.append(sh["W_rec"].reshape(d, -1, 4 * w))

    H = params["W_in"].shape[-1]
    h_full = [xi.new_zeros(d, B, H) for xi in xs]
    c = [xi.new_zeros(d, B, sh["W_in"].shape[-1])
         for xi, sh in zip(xs, shards)]
    hist = [[] for _ in mesh]
    for t in range(T):
        h_new = []
        for i in range(n):
            w = shards[i]["W_in"].shape[-1]
            a = acts[i][t] + torch.bmm(h_full[i], w_recs[i]).view(d, B, 4, w)
            h_i, c_i, _ = lstm_cell_step(a, c[i], shards[i]["peep"], False,
                                         gclip)
            h_new.append(h_i * masks[i][t])
            c[i] = c_i * masks[i][t]
        # the all_gather: every device assembles the full h of this step
        h_full = [torch.cat([h.to(dev) for h in h_new], dim=-1)
                  for dev in mesh]
        for j in range(n):
            hist[j].append(h_full[j])
    outs = []
    for j in range(n):
        ys = torch.stack(hist[j])  # [T, D, B, H]
        y = torch.cat([ys[:, 0], ys.flip(0)[:, 1]], dim=-1) \
            if bidirectional else ys[:, 0]
        outs.append(y.to(dtype))
    return outs
