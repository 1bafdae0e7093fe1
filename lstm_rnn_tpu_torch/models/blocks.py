"""An LSTM layer in time blocks on the carry kernels: the wavefront
schedule shared by sequence parallelism (parallel/sequence.py: block i on
device i of a mesh) and by gradient checkpointing (`--remat_blocks`,
models/lstm.py: every block on one device, each one checkpointed).

A layer's time axis is cut into n blocks. In round r the block holding
time block r scans its frames from the carried (h, c) and hands its final
state to block r + 1; a BLSTM layer's backward half runs the opposite
wavefront (block n-1 first). Both directions' blocks of a round are
launched before either carry moves, so on a mesh two devices work in
every round. The carry hop is `move(.., mesh[i +- 1])` (parallel/mesh.py:
`.to`, a no-op when the device repeats, whose backward between two GPUs
a step graph can capture); autograd carries the carry cotangents back
along it. On a mesh
that spans processes (parallel/mesh.py `SpanMesh`) each process runs its
own blocks, and a carry between two processes goes through parallel/
hop.py's chain.

The kernel route (`fused_wavefront`) runs each block of each direction
through `lstm_scan_fused_carry` (D = 1, dir_offset = d, prefix lengths
from the block's pattypes): under autograd its forward with residuals and
its BPTT (K6b), without it the inference carry kernel (K6f). With
`remat`, each block's call goes under `torch.utils.checkpoint` (non-
reentrant): the forward keeps only the block's inputs and carries, and the
backward runs the block's forward again for its residuals before the BPTT.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from lstm_rnn_tpu_torch.ops.lstm_cell import lstm_scan_fused_carry
from lstm_rnn_tpu_torch.parallel.mesh import move


def per_device(p, mesh):
    """{device: the layer's parameters on it}, one copy per distinct
    device of the mesh that this process drives."""
    return {dev: {k: move(v, dev) for k, v in p.items()}
            for dev in set(mesh) - {None}}


def wavefront(run_block, n_dirs: int, mesh, batch: int, hidden: int,
              chain=None):
    """The round schedule shared by the routes. run_block(d, i, h0, c0)
    scans direction d over block i from (h0, c0) [1, B, H] f32 on mesh[i]
    and returns (y [Tl, B, H] on mesh[i], hf, cf). Direction 0's carry
    enters block 0 and travels up, direction 1's enters block n-1 and
    travels down, both from zero. Returns outs[d][i].

    With `chain` (parallel/hop.py: the mesh spans processes, mesh[i] is
    None where another process owns block i) only this process's blocks
    run; a carry whose next block another process owns goes to it
    through the chain as one [2, 1, B, H] message (h and c), and one that
    arrives from another process comes the same way. outs[d][i] is None
    for another process's block."""
    n = len(mesh)

    def own(i):
        return chain is None or chain.span.owns(i)

    state = [None] * n_dirs
    for d in range(n_dirs):
        i = 0 if d == 0 else n - 1
        if own(i):
            zero = torch.zeros(1, batch, hidden, device=mesh[i])
            state[d] = (zero, zero)
    outs = [[None] * n for _ in range(n_dirs)]
    for r in range(n):
        ran = []
        for d in range(n_dirs):
            i = r if d == 0 else n - 1 - r
            if own(i):
                y, hf, cf = run_block(d, i, *state[d])
                outs[d][i] = y
                ran.append((d, i, hf, cf))
            else:
                ran.append((d, i, None, None))
        # every direction's block of the round is launched before a carry
        # moves, so the two active devices compute together; every
        # process takes the hops in this one order
        for d, i, hf, cf in ran:
            j = i + 1 if d == 0 else i - 1
            if not 0 <= j < n:
                continue
            if own(i) and own(j):
                state[d] = (move(hf, mesh[j]), move(cf, mesh[j]))
            elif own(i):
                chain.send(torch.stack([hf, cf]), i, j)
            elif own(j):
                hc = chain.recv(i, j, (2, 1, batch, hidden), torch.float32)
                state[d] = (hc[0], hc[1])
    return outs


def fused_wavefront(params, xs, pts, bias_mult, bidirectional, mesh,
                    compute_dtype, remat: bool = False, chain=None):
    """The kernel route's wavefront: each block of each direction is one
    `lstm_scan_fused_carry` call (D = 1; dir_offset = 1 runs the BLSTM's
    backward half descending over the block's natural-order arrays),
    the input projection inside it; with `remat`, a checkpointed one.
    Validity is each row's prefix within the block: a row's valid frames
    are a global prefix, so within a block they are a prefix too (zero
    frames in the blocks after its end). With `chain` (a mesh that spans
    processes) xs[i] and pts[i] are None for another process's block,
    which takes no call. Returns outs[d][i]."""
    n_dirs = 2 if bidirectional else 1
    _, P, _, H = params["W_in"].shape
    on = per_device(params, mesh)
    lengths = [None if pt is None else
               (pt != 0).sum(dim=0, dtype=torch.int32) for pt in pts]
    batch = next(x for x in xs if x is not None).shape[1]

    def block(d, i, x, h0, c0):
        dev = mesh[i]
        p = on[dev]
        # the kernel entry points make the block's GPU current; the guard
        # restores the caller's
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            y, (hf, cf) = lstm_scan_fused_carry(
                x, p["W_in"][d:d + 1].reshape(1, P, 4 * H),
                p["W_rec"][d:d + 1].reshape(1, H, 4 * H),
                p["peep"][d:d + 1], p["b"][d:d + 1].reshape(1, 4 * H),
                lengths[i], h0, c0, float(bias_mult), True, compute_dtype,
                True, None, d)
        return y, hf, cf

    def run(d, i, h0, c0):
        if remat:
            # the block draws no random numbers: the RNG state needs no
            # saving and restoring (nor reading in a step graph's capture)
            return checkpoint(block, d, i, xs[i], h0, c0,
                              use_reentrant=False, preserve_rng_state=False)
        return block(d, i, xs[i], h0, c0)

    return wavefront(run, n_dirs, mesh, batch, H, chain)


def pad_time(x, targets, pattypes, n: int):
    """Pad T to a multiple of n with PATTYPE_NONE rows: numerically inert
    (the losses and counters mask them; the LSTM zeroes h and c there, and
    a row's valid frames stay a prefix). The JAX package pads to a
    multiple of 16 n on its sequence-parallel kernel route, because its
    Mosaic kernels chunk time by 16 and local chunk padding would zero
    mid-stream carries; the CUDA kernels have no such rule. targets may be
    None; pattypes may be any [T, ...] validity whose zero is invalid (the
    scan's step mask). Returns (x, targets, pattypes, the original T)."""
    t = x.shape[0]
    dt = -t % n
    if not dt:
        return x, targets, pattypes, t
    x = torch.cat([x, x.new_zeros((dt,) + x.shape[1:])])
    pattypes = torch.cat([pattypes, pattypes.new_zeros((dt,)
                                                       + pattypes.shape[1:])])
    if targets is not None:
        fill = -1 if targets.dim() == 2 else 0
        targets = torch.cat([targets, targets.new_full(
            (dt,) + targets.shape[1:], fill)])
    return x, targets, pattypes, t
