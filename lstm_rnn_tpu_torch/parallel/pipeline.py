"""Pipeline parallelism over the layer stack, in one process.

Counterpart of lstm_rnn_tpu/parallel/pipeline.py, whose functions and
names it keeps. The hidden layers (specs[1:-1], the softmax layer
counted) split into contiguous stages (`stage_ranges`), stage s on
mesh[s] of a pipe mesh (parallel/mesh.py: an ordered list of devices,
which may name one device several times). A fraction's batch axis is cut
into m microbatches, microbatch i the i-th run of consecutive columns,
and the stages run GPipe's schedule: at tick k stage s takes microbatch
k - s, so that on distinct GPUs the stages work at once. The loss and the
count are sums over the microbatches; serving returns exactly [T, B,
out].

Where the JAX package runs a `lax.scan` of ticks under shard_map with a
ppermute of padded stage messages, the port uses plain tensors on the
mesh's devices:
- the host enqueues tick by tick, and each stage's work goes to its
  device's stream, so the GPUs overlap as the ticks allow;
- a stage's output passes to the next stage by a differentiable
  `move(.., mesh[s + 1], non_blocking=True)` (parallel/mesh.py: `.to`,
  whose backward between two GPUs a step graph can capture); autograd
  carries the cotangents back along it (the ppermute's transpose).
  Messages are the activations as they are, with no padding to a common
  width: that was for a uniform ICI transfer;
- every (stage, microbatch) forward runs under `torch.utils.checkpoint`
  when autograd records: GPipe's per-microbatch rematerialization, the
  counterpart of the JAX package's `jax.checkpoint(tick)` (no RNG state
  is saved: a stage draws no random numbers, and so a step graph can
  hold it, as graphs.py's do under --fuse_fractions). A stage then
  keeps only its microbatches' inputs, and the backward runs each
  (stage, microbatch) forward once more before its backward. So a
  training step launches each LSTM layer's training forward (K1) twice
  per microbatch and its BPTT (K2) once, and the tail's forward twice
  and its backward once; serving and validation (no autograd) run each
  once, with the inference kernels (K0);
- the parameters live once, on mesh[0] (the Trainer's device). Each
  stage takes a differentiable copy of its own layers once a call
  (`move(.., mesh[s])`, a no-op when the device repeats), so the gradients
  arrive on mesh[0] and the update, the autosaves and --continue stay as
  they are.

The last stage ends with the net's loss. Where the net takes the fused
tail (`Network.takes_fused_tail`: a softmax -> multiclass net on the
kernel backends), it is `Network.fused_tail` over the stage's hidden
output, the same choice of K3, K4 or K5 as the one-device step's
(network.py `loss_and_count_fused`), so a pipelined TIMIT or LVCSR step
runs the same tail kernels. Other nets take the unfused `net.loss_fn` and
`net.correct_count`, the JAX pipeline's loss, which is also what the
fused tail is held against: the two differ by f32 reduction order.

Ragged batches pad to a multiple of m with PATTYPE_NONE columns (targets
-1 in classification, zeros in regression), which the losses, counts and
LSTM layers ignore. Under data parallelism (DP x PP) each rank calls
these functions on its block of B and its own pipe mesh, and the block is
padded the same way.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from lstm_rnn_tpu_torch.ops.masking import PATTYPE_NONE
from lstm_rnn_tpu_torch.parallel import hop
from lstm_rnn_tpu_torch.parallel.mesh import move


def stage_ranges(n_layers: int, n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous balanced [lo, hi) ranges over the hidden layers, rounded
    as the JAX package rounds them (numpy's round half to even: 6 layers
    over 4 stages give (0, 2), (2, 3), (3, 4), (4, 6))."""
    if n_stages > n_layers:
        raise ValueError(
            f"pipeline_devices={n_stages} exceeds the {n_layers} hidden "
            "layers — nothing to place on the extra stages")
    bounds = np.linspace(0, n_layers, n_stages + 1).round().astype(int)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_stages)]


def loss_and_count_pipelined(net, params, x, targets, pattypes,
                             mesh: Sequence[torch.device],
                             microbatches: int = 0):
    """(total error, correct count) of the full net, pipeline-parallel, on
    mesh[0]. x [T, B, F], targets [T, B] int or [T, B, W], pattypes
    [T, B], all on mesh[0] with the parameters. microbatches: m (0 = the
    stage count). Differentiable: autograd gives the one-device
    gradients on mesh[0].

    On a pipe mesh that spans processes (parallel/mesh.py `SpanMesh`)
    every process passes the whole fraction on its first device
    (`mesh.home`) and runs its own stages: the error and count are the
    last stage's process's (zero elsewhere), and each process's gradients
    are those of its stages' layers (zero for the others'), so that their
    sums over the processes are the fraction's. The stage messages and
    their cotangents cross over parallel/hop.py's chain."""
    return _pipelined(net, params, x, targets, pattypes, mesh, microbatches)


def apply_pipelined(net, params, x, pattypes, mesh: Sequence[torch.device],
                    microbatches: int = 0):
    """Pipeline-parallel forward pass: [T, B, output_size] activations on
    mesh[0], the serving twin of loss_and_count_pipelined (the CLI's
    forward mode with --pipeline_devices)."""
    return _pipelined(net, params, x, None, pattypes, mesh, microbatches)


def _pad_columns(x, targets, pattypes, gran: int):
    """B padded to a multiple of gran with inert columns."""
    pad = -x.shape[1] % gran
    if not pad:
        return x, targets, pattypes
    x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], dim=1)
    pattypes = torch.cat([pattypes, pattypes.new_full(
        (pattypes.shape[0], pad), PATTYPE_NONE)], dim=1)
    if targets is not None:
        targets = torch.cat([targets, targets.new_full(
            (targets.shape[0], pad) + targets.shape[2:],
            -1 if targets.dim() == 2 else 0)], dim=1)
    return x, targets, pattypes


def _device_guard(dev: torch.device):
    """The stage's GPU current while its work is issued (the kernels'
    entry points launch on the current device's stream)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _pipelined(net, params, x, targets, pattypes, mesh, microbatches):
    chain = hop.step_chain(mesh, params)
    if chain is not None and targets is None:
        raise ValueError("pipelined serving over several processes is not "
                         "supported (the JAX CLI refuses it too)")
    if chain is None:
        mesh = [torch.device(d) for d in mesh]
    n_stages = len(mesh)
    hidden = net.specs[1:-1]
    ranges = stage_ranges(len(hidden), n_stages)
    want_outputs = targets is None
    b = x.shape[1]
    m = microbatches if microbatches and microbatches > 0 else n_stages
    x, targets, pattypes = _pad_columns(x, targets, pattypes, m)
    bm = x.shape[1] // m
    fused = not want_outputs and net.takes_fused_tail()
    last = n_stages - 1
    own = [chain is None or mesh.owns(s) for s in range(n_stages)]
    home = mesh[0] if chain is None else mesh.home

    # each owned stage's own layers, one differentiable copy per call
    stage_params = [
        {s.name: {k: move(v, mesh[i]) for k, v in params[s.name].items()}
         for s in hidden[lo:hi]} if own[i] else None
        for i, (lo, hi) in enumerate(ranges)]

    def cols(a, i, dev):
        return None if a is None else \
            a[:, i * bm:(i + 1) * bm].to(dev).contiguous()

    # microbatch i's pattypes on every owned stage's device, its targets
    # on the last stage's
    pts = [[cols(pattypes, i, dev) if own[s] else None
            for s, dev in enumerate(mesh)] for i in range(m)]
    tgs = [cols(targets, i, mesh[last]) if own[last] else None
           for i in range(m)]

    def stage(s, i, inp):
        lo, hi = ranges[s]
        with _device_guard(mesh[s]):
            if s < last or want_outputs:
                return net.apply_layer_range(stage_params[s], inp,
                                             pts[i][s], lo, hi)
            if fused:
                h = net.apply_layer_range(stage_params[s], inp, pts[i][s],
                                          lo, hi - 1)
                return net.fused_tail(stage_params[s], h, tgs[i])
            y = net.apply_layer_range(stage_params[s], inp, pts[i][s], lo,
                                      hi)
            return (net.loss_fn(y, tgs[i], pts[i][s]),
                    net.correct_count(y, tgs[i], pts[i][s]))

    remat = torch.is_grad_enabled()

    def run(s, i, inp):
        if remat:
            return checkpoint(stage, s, i, inp, use_reentrant=False,
                              preserve_rng_state=False)
        return stage(s, i, inp)

    def message(s):
        """The [T, bm, width] message stage s hands on: the output of its
        last layer, in the inputs' dtype."""
        return (x.shape[0], bm, hidden[ranges[s][1] - 1].size), x.dtype

    # GPipe's ticks: stage s on microbatch k - s; msgs[s] holds the
    # message stage s received at the previous tick. A message to another
    # process goes once every owned stage of the tick has been issued,
    # outside the stage's checkpoint (a recompute sends nothing), and
    # every process takes those hops in one order
    msgs = [None] * n_stages
    results = [None] * m
    for k in range(m + n_stages - 1):
        sent = [None] * n_stages
        out = [None] * n_stages
        for s in range(n_stages):
            i = k - s
            if not (0 <= i < m and own[s]):
                continue
            inp = cols(x, i, mesh[0]) if s == 0 else msgs[s]
            out[s] = run(s, i, inp)
            if s == last:
                results[i] = out[s]
            elif own[s + 1]:
                sent[s + 1] = move(out[s], mesh[s + 1], non_blocking=True)
        for s in range(n_stages - 1):
            if not 0 <= k - s < m or own[s] == own[s + 1]:
                continue
            if own[s]:
                shape, dtype = message(s)
                if (tuple(out[s].shape), out[s].dtype) != (shape, dtype):
                    raise RuntimeError(
                        f"stage {s} would send {tuple(out[s].shape)} "
                        f"{out[s].dtype}; stage {s + 1} expects {shape} "
                        f"{dtype}")
                chain.send(out[s], s, s + 1)
            else:
                sent[s + 1] = chain.recv(s, s + 1, *message(s))
        msgs = sent

    if want_outputs:
        return torch.cat([y.to(home) for y in results], dim=1)[:, :b]
    if not own[last]:
        err = torch.zeros((), dtype=x.dtype, device=home)
        return chain.close(err), torch.zeros((), dtype=torch.int64,
                                             device=home)
    err = torch.stack([move(e, home) for e, _ in results]).sum()
    corr = torch.stack([c.to(home) for _, c in results]).sum()
    return (err if chain is None else chain.close(err)), corr
