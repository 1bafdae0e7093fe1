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
`lax.scan`, the port keeps the shards on the mesh's devices, driven from
one process:
- the parameters live once, on mesh[0] (the Trainer's device); each
  device takes a differentiable copy of its columns (`shard_lstm_params`:
  a slice, then parallel/mesh.py `move`, a no-op when the device
  repeats), so autograd assembles the full gradients on mesh[0];
- each shard's input projection (plus bias) over all T is a plain
  product on its device, as JAX's einsum outside the scan;
- the recurrence is `LstmTPFused` (ops/lstm_tp.py): on the GPUs the
  hand-written kernels K8f and K8b (csrc/lstm_tp.cu), one launch a layer
  and GPU that runs every step, with the all_gather of h (peer stores
  into every GPU's output) and the BPTT's reduce_scatter inside the
  kernels; on the CPU their twins, a Python loop over time;
- every distinct device holds the layer's whole output, so the next
  tensor-parallel layer's input projection reads it where it lies, with
  no second copy (the function returns one replica per mesh entry,
  mesh[0]'s first).

`lstm_forward_tp_reference` is that loop as a differentiable function of
the parameters (autograd through every step, the delta clip wrapped
around each gate as the scan route wraps it): the tests' plain
counterpart of the whole layer.

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
from lstm_rnn_tpu_torch.ops.lstm_tp import (LstmTPFused, TPSpec, _tp_loop,
                                            lstm_tp_fwd)
from lstm_rnn_tpu_torch.parallel.mesh import move


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
    return [{k: move(v[..., i * w:(i + 1) * w], dev)
             for k, v in params.items()} for i, dev in enumerate(mesh)]


def _operands(params, x, pattypes, bias_mult, bidirectional, mesh):
    """The recurrence's operands a shard, in mesh order: its projection
    plus bias acts [T, D, B, 4, w] (scan order: direction 1 reversed in
    time), W_rec [D, H, 4, w], peep [D, 3, w], and the validity [T, D, B]
    (scan order) on its device; and x's dtype."""
    d = params["W_in"].shape[0]
    if d != (2 if bidirectional else 1):
        raise ValueError(f"W_in has {d} directions; bidirectional="
                         f"{bidirectional}")
    shards = shard_lstm_params(mesh, params)
    xs = list(x) if isinstance(x, (list, tuple)) else [move(x, dev)
                                                       for dev in mesh]
    dtype = xs[0].dtype
    T, B, _ = xs[0].shape
    valid = (pattypes != 0).to(dtype)[:, None, :]  # [T, 1, B]
    mask = torch.cat([valid, valid.flip(0)], dim=1) if bidirectional \
        else valid
    by_dev = {dev: mask.to(dev) for dev in dict.fromkeys(mesh)}
    masks = [by_dev[dev] for dev in mesh]
    acts = []
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
        acts.append(a.contiguous())
    w_recs = [sh["W_rec"].contiguous() for sh in shards]
    peeps = [sh["peep"].contiguous() for sh in shards]
    return acts, w_recs, peeps, masks, dtype


def _replicas(outs, mesh, dtype):
    gpus = list(dict.fromkeys(mesh))
    return [outs[gpus.index(dev)].to(dtype) for dev in mesh]


def lstm_forward_tp(params, x, pattypes, bias_mult: float,
                    bidirectional: bool, mesh: Sequence[torch.device],
                    clip_gradients: bool = True,
                    name: str = "a TP layer") -> List[torch.Tensor]:
    """Tensor-parallel counterpart of `lstm_forward`'s scan route.

    params: one layer's tree (W_in [D, P, 4, H], ...), H divisible by the
    mesh's length; x: [T, B, P], or a list of it on every device of the
    mesh (the previous tensor-parallel layer's replicas); pattypes [T, B]
    on mesh[0]. Returns the layer's output [T, B, L] ([fw | bw] per
    frame, in x's dtype) on every device of the mesh, mesh[0]'s first
    (entries of one device are one tensor). The recurrence runs in
    `LstmTPFused` where autograd records, else K8f (or its twin) alone;
    `name` names the layer in a kernel's error."""
    mesh = list(mesh)
    acts, w_recs, peeps, masks, dtype = _operands(
        params, x, pattypes, bias_mult, bidirectional, mesh)
    ops = (*acts, *w_recs, *peeps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        spec = TPSpec(tuple(mesh), tuple(masks), clip_gradients, name)
        outs = LstmTPFused.apply(spec, *ops)
    else:
        outs, _, _ = lstm_tp_fwd(mesh, acts, w_recs, peeps, masks,
                                 name=name)
    return _replicas(outs, mesh, dtype)


def lstm_forward_tp_reference(params, x, pattypes, bias_mult: float,
                              bidirectional: bool,
                              mesh: Sequence[torch.device],
                              clip_gradients: bool = True
                              ) -> List[torch.Tensor]:
    """`lstm_forward_tp` as a Python loop over time with autograd through
    every step (the layer before the kernels): the same operands and
    returns. Gradients come from autograd of the loop, the delta clip
    wrapped around each gate preactivation."""
    mesh = list(mesh)
    acts, w_recs, peeps, masks, dtype = _operands(
        params, x, pattypes, bias_mult, bidirectional, mesh)
    outs, _, _ = _tp_loop(acts, w_recs, peeps, masks, mesh,
                          grad_clip if clip_gradients else None)
    return _replicas(outs, mesh, dtype)
