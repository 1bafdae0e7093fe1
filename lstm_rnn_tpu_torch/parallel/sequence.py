"""Sequence parallelism over the time axis, in one process.

Counterpart of lstm_rnn_tpu/parallel/sequence.py, whose functions and
names it keeps. The fraction's time axis is cut into n blocks, block i on
mesh[i] (parallel/mesh.py: an ordered list of devices, which may name one
device several times). Everything frame-local runs block by block: the
LSTM input projections, the feedforward and softmax layers, the loss and
the count, summed on mesh[0] (the JAX package's psum). The LSTM recurrence
runs as a wavefront (models/blocks.py, whose schedule --remat_blocks
shares): in round r the block holding time block r scans its frames from
the carried (h, c) and hands its final state to block r + 1; a BLSTM
layer's backward half runs the opposite wavefront (block n-1 first), and
both directions' blocks of a round are launched before either carry
moves, so two devices work in every round.

Where the JAX package uses shard_map and ppermute, the port uses plain
tensors on the mesh's devices:
- the carry hop is `move(.., mesh[i +- 1])` (parallel/mesh.py: `.to`,
  whose backward between two GPUs a step graph can capture); autograd
  carries the carry cotangents back along it (the ppermute's transpose);
- the parameters live once, on mesh[0]; each block takes `move(p,
  mesh[i])` (a no-op when the device repeats), so autograd sums every
  block's gradient into the leaf (the JAX package's psum over the axis);
- no per-round checkpoint is needed (the JAX package's jax.checkpoint of
  the round scan, sequence.py:159-171): each block's residuals live on
  its own device from the start.

Two routes, as the JAX package has them: the kernel route
(`fused_wavefront`, backend "auto"/"pallas") runs each block of each
direction through `lstm_scan_fused_carry` (D = 1, dir_offset = d, prefix
lengths from the block's pattypes): under autograd its forward with
residuals and its BPTT (K6b), without it the inference carry kernel (K6f);
the scan route (`_scan_block`, backend "scan") runs `_lstm_scan` from the
carried state, and autograd differentiates it.

Composed with data parallelism (DP x SP, the JAX package's ('data',
'seq') mesh, whose `data_ax` shards B), each data-parallel rank is a
worker process of its own (parallel/launch.py) that calls these functions
on its block of B and its own seq mesh: the blocks' gradients are summed
into the leaves on the mesh's first device by autograd, as above, and the
psum over 'data' is the data group's all-reduce that follows
(Trainer(seq_mesh=, data_group=), parallel/data.py).
"""

from __future__ import annotations

import torch

from lstm_rnn_tpu_torch import io_currennt as ioc
from lstm_rnn_tpu_torch.models.blocks import (fused_wavefront, pad_time,
                                              per_device, wavefront)
from lstm_rnn_tpu_torch.models.feedforward import (feedforward_forward,
                                                   softmax_forward)
from lstm_rnn_tpu_torch.models.lstm import (_lstm_scan, _needs_grad,
                                          _scan_acts_valid, kernel_route)
from lstm_rnn_tpu_torch.parallel import hop
from lstm_rnn_tpu_torch.parallel.mesh import move


def _scan_block(acts, w_rec, peep, mask, compute_dtype, h0, c0):
    """Scan one direction's time block from an explicit carry (the scan
    route). acts [Tl, 1, B, 4, H] projections + bias, in scan order;
    w_rec [1, H, 4, H]; peep [1, 3, H]; mask [Tl, 1, B, 1]; h0, c0
    [1, B, H]. The same math as the single-device `_lstm_scan`, which it
    calls, so chained blocks equal the whole sequence. Returns (ys
    [Tl, 1, B, H] in the storage dtype, h_t, c_t)."""
    ys, (h_t, c_t) = _lstm_scan(acts, w_rec, peep, mask, compute_dtype,
                                init=(h0, c0), return_carry=True)
    return ys, h_t, c_t


def _scan_wavefront(params, xs, pts, bias_mult, bidirectional, mesh,
                    compute_dtype, chain=None):
    """The scan route's wavefront: each block's projections once, then
    `_scan_block` per direction and block (the backward half over
    time-reversed blocks). With `chain`, this process's blocks only."""
    n_dirs = 2 if bidirectional else 1
    H = params["W_in"].shape[-1]
    on = per_device(params, mesh)
    proj = [None if x is None else
            _scan_acts_valid(x, pt, on[dev]["W_in"], on[dev]["b"],
                             bias_mult, compute_dtype)
            for x, pt, dev in zip(xs, pts, mesh)]
    batch = next(x for x in xs if x is not None).shape[1]

    def run(d, i, h0, c0):
        acts, valid = proj[i]
        a, m = acts[:, d:d + 1], valid
        if d:
            a, m = a.flip(0), m.flip(0)
        p = on[mesh[i]]
        ys, h_t, c_t = _scan_block(a, p["W_rec"][d:d + 1],
                                   p["peep"][d:d + 1], m, compute_dtype,
                                   h0, c0)
        ys = ys[:, 0]
        return (ys.flip(0) if d else ys), h_t, c_t

    return wavefront(run, n_dirs, mesh, batch, H, chain)


def lstm_forward_seq(params, xs, pts, bias_mult: float, bidirectional: bool,
                     mesh, compute_dtype: torch.dtype = torch.float32,
                     backend: str = "auto", chain=None):
    """One (B)LSTM layer over a time-sharded sequence. xs, pts: the
    [Tl, B, P] input blocks and their [Tl, B] pattypes, block i on
    mesh[i] (the JAX function takes one device's block inside shard_map;
    here one call takes them all). Returns the [Tl, B, L] output blocks
    (L = H or 2H, [fw | bw] per frame) in the inputs' dtype. backend
    "scan" takes the scan route, any other the kernel route where the
    kernels take the width (models/lstm.py kernel_route)."""
    w_in = params["W_in"]
    if w_in.shape[0] != (2 if bidirectional else 1):
        raise ValueError(f"W_in has {w_in.shape[0]} directions; "
                         f"bidirectional={bidirectional}")
    kernels = kernel_route(backend, w_in.shape[-1], compute_dtype,
                           _needs_grad(*(x for x in xs if x is not None),
                                       *params.values()))
    route = fused_wavefront if kernels else _scan_wavefront
    outs = route(params, xs, pts, bias_mult, bidirectional, mesh,
                 compute_dtype, chain=chain)
    ys = []
    for i, x in enumerate(xs):
        if x is None:
            ys.append(None)
            continue
        y = outs[0][i] if len(outs) == 1 else torch.cat(
            [outs[0][i], outs[1][i]], dim=-1)
        ys.append(y.to(x.dtype))
    return ys


def loss_and_count_seq(net, params, x, targets, pattypes, mesh):
    """(total error, correct count) of the full net, sequence-parallel,
    on mesh[0]. x [T, B, F], targets [T, B] int or [T, B, W], pattypes
    [T, B], all on mesh[0] with the parameters. Differentiable: autograd
    gives the single-device gradients, summed over the blocks.

    On a mesh that spans processes (parallel/mesh.py `SpanMesh`) every
    process passes the whole fraction on its first device (`mesh.home`,
    where its parameters live) and gets the error and count of its own
    blocks there: their sums over the processes are the fraction's, and
    so are the sums of the gradients autograd gives each of them (the
    carries' cotangents cross over parallel/hop.py's chain)."""
    return _seq_run(net, params, x, targets, pattypes, mesh,
                    want_outputs=False)


def apply_seq(net, params, x, pattypes, mesh):
    """Sequence-parallel forward pass: [T, B, output_size] activations on
    mesh[0], the serving twin of loss_and_count_seq (the CLI's forward mode
    with --seq_devices). Without autograd its LSTM blocks run the
    inference carry kernel."""
    return _seq_run(net, params, x, None, pattypes, mesh, want_outputs=True)


def _seq_run(net, params, x, targets, pattypes, mesh, want_outputs):
    n = len(mesh)
    x, targets, pattypes, t = pad_time(x, targets, pattypes, n)
    tl = x.shape[0] // n
    chain = hop.step_chain(mesh, params)
    if chain is not None and want_outputs:
        raise ValueError("sequence-parallel serving over several processes "
                         "is not supported (the JAX CLI refuses it too)")
    home = mesh[0] if chain is None else mesh.home
    owned = [i for i in range(n) if chain is None or mesh.owns(i)]

    def split(a):
        out = [None] * n
        for i in owned:
            out[i] = a[i * tl:(i + 1) * tl].to(mesh[i])
        return out

    hs, pts = split(x), split(pattypes)
    for s in net.specs[1:-1]:
        p = params[s.name]
        if s.type in ioc.LSTM_TYPES:
            hs = lstm_forward_seq(p, hs, pts, s.bias, ioc.LSTM_TYPES[s.type],
                                  mesh, net.compute_dtype, net.backend,
                                  chain)
            continue
        on = per_device(p, mesh)
        for i in owned:
            if s.type == "softmax":
                hs[i] = softmax_forward(on[mesh[i]], hs[i], s.bias,
                                        net.compute_dtype)
            else:
                hs[i] = feedforward_forward(on[mesh[i]], hs[i],
                                            ioc.FEEDFORWARD_TYPES[s.type],
                                            s.bias, net.compute_dtype)
    if want_outputs:
        return torch.cat([h.to(home) for h in hs])[:t]
    tgs = split(targets)
    err = torch.stack([move(net.loss_fn(hs[i], tgs[i], pts[i]), home)
                       for i in owned]).sum()
    corr = torch.stack([net.correct_count(hs[i], tgs[i], pts[i]).to(home)
                        for i in owned]).sum()
    return (err if chain is None else chain.close(err)), corr
