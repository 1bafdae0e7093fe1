"""Data parallelism: one process per device over a torch.distributed group.

Counterpart of lstm_rnn_tpu/parallel/mesh.py's `make_mesh`,
`data_axis_size` and `shard_fraction`, and of parallel/distributed.py's
`process_index`, `process_count`, `is_coordinator` and `host_local_slice`.

The JAX package shards every fraction's batch axis over a 1-D "data" mesh
in one program and lets XLA emit the gradient psum. The port runs one
worker process per device (parallel/launch.py starts them), joined by a
torch.distributed process group (NCCL on CUDA, gloo on the CPU):

- every rank loads the same DataSet with the same seed and builds the
  same parameters, so the fraction stream, the shuffles, the input noise
  and the weight noise are the same everywhere;
- each fraction's B is padded up to a multiple of the world size with
  inert rows (`pad_batch`: PATTYPE_NONE, targets -1 or 0), and rank r
  moves only its contiguous block r (`local_block`; rank order is block
  order, process-major across hosts, as the JAX mesh's device order);
- the gradients and the pass's metrics are summed over the ranks, never
  averaged (`all_reduce_sum`: CURRENNT's gradient is a sum over patterns,
  as the JAX psum is), packed into one flat buffer per dtype, so an update
  costs one collective;
- serving outputs come back to rank 0 (`gather_blocks`), which writes
  every file.

Composed with sequence parallelism (DP x SP), a rank also holds its seq
mesh (`DataGroup.seq_mesh`, parallel/mesh.py `composed_mesh`): its block
of B runs through parallel/sequence.py on that mesh, whose first device is
the rank's `device`, where its parameters live; the gradients summed into
them over the blocks are then summed over the ranks as above. Composed
with pipeline or tensor parallelism (DP x PP, DP x TP) the rank holds a
pipe mesh (`pipe_mesh`: its block runs parallel/pipeline.py's stages) or a
model mesh (`model_mesh`: its LSTM layers shard their cells,
parallel/tensor.py) the same way.

A seq or pipe mesh that spans processes (`DataGroup.span`) reuses the
group without its batch split: every process takes the whole fraction,
runs its own blocks or stages, and `all_reduce_sum` adds up the
processes' gradients and (error, count), as the JAX package's psum over
the mesh axis does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from lstm_rnn_tpu_torch.ops.masking import PATTYPE_NONE


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank of a data-parallel run: its global rank, the world size,
    its device, the processes (hosts) of the job, the torch.distributed
    group (None: the default group) and, under DP x SP, DP x PP or DP x
    TP, the rank's seq, pipe or model mesh (a tuple of devices whose
    first is `device`; at most one of them, None without).

    With `span` (parallel/mesh.py `SpanMesh`: a 1-D seq or pipe mesh over
    every process's devices) the ranks are the mesh's processes, not
    data-parallel ones: each holds its positions of the one mesh, whose
    owners and hop groups `span` gives, `device` is its first one
    (`span.home`), every rank takes the whole fraction (`block`), and the
    sums over the ranks add up the processes' shares of one step."""
    rank: int
    size: int
    device: torch.device
    hosts: int = 1
    group: Any = None
    seq_mesh: Optional[tuple] = None
    pipe_mesh: Optional[tuple] = None
    model_mesh: Optional[tuple] = None
    span: Any = None

    @property
    def is_coordinator(self) -> bool:
        """Global rank 0 prints the tables and writes every file."""
        return self.rank == 0

    def mesh_line(self, what: str = "mesh") -> str:
        """The JAX CLI's banner (lstm_rnn_tpu/cli.py:352, :359, :369, :378,
        :600, :615, :678, :727): "DP x SP mesh", "DP x PP mesh" or "DP x TP
        mesh" with a rank's mesh, whatever the mode."""
        for name, axis, mesh in (("SP", "seq", self.seq_mesh),
                                 ("PP", "pipe", self.pipe_mesh),
                                 ("TP", "model", self.model_mesh)):
            if mesh is not None:
                return (f"DP x {name} mesh: {{'data': {self.size}, "
                        f"'{axis}': {len(mesh)}}}")
        hosts = f" over {self.hosts} hosts" if self.hosts > 1 else ""
        return f"Data-parallel {what}: {{'data': {self.size}}}{hosts}"

    def block(self, inputs, targets, pattypes):
        """This rank's contiguous host arrays of a fraction's [T, B, ...]
        arrays, B padded to a multiple of the world size (pad_batch);
        targets may be None. Under a span, the whole fraction."""
        if self.span is not None:
            return [inputs, targets, pattypes]
        return [None if a is None else np.ascontiguousarray(
                    local_block(a, self.rank, self.size))
                for a in pad_batch(inputs, targets, pattypes, self.size)]


def pad_batch(inputs: np.ndarray, targets: Optional[np.ndarray],
              pattypes: np.ndarray, k: int):
    """Pad a fraction's [T, B, ...] host arrays along B up to a multiple of
    k with inert rows: zero inputs, PATTYPE_NONE, and the dummy targets
    the DataSet gives its own padding (-1 for classes, zeros otherwise;
    lstm_rnn_tpu/trainer.py `_pad_fraction`). They add nothing to the
    error, the count or a gradient. targets may be None (serving)."""
    pad = -pattypes.shape[1] % k
    if not pad:
        return inputs, targets, pattypes
    inputs = np.pad(inputs, ((0, 0), (0, pad), (0, 0)))
    pattypes = np.pad(pattypes, ((0, 0), (0, pad)),
                      constant_values=PATTYPE_NONE)
    if targets is not None:
        widths = ((0, 0), (0, pad)) + ((0, 0),) * (targets.ndim - 2)
        targets = np.pad(targets, widths,
                         constant_values=-1 if targets.ndim == 2 else 0)
    return inputs, targets, pattypes


def local_block(array, rank: int, k: int):
    """Rank `rank`'s contiguous block of a [T, B, ...] array along B, whose
    length k must divide (after pad_batch); numpy arrays and tensors
    alike."""
    n = array.shape[1]
    if n % k:
        raise ValueError(f"batch {n} is not a multiple of the world size {k}"
                         " (pad_batch first)")
    per = n // k
    return array[:, rank * per:(rank + 1) * per]


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over the ranks, in place. The tensors are packed
    into one flat buffer per dtype, so a call costs one collective per
    dtype (one for a float32 net's gradients) and not one per parameter.
    `all_reduce_sum.collectives` counts the collectives issued."""
    import torch.distributed as dist
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        all_reduce_sum.collectives += 1
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


all_reduce_sum.collectives = 0


def gather_blocks(y: torch.Tensor, dg: DataGroup) -> Optional[torch.Tensor]:
    """Every rank's [T, B / k, ...] block of a serving output, concatenated
    along B in rank order on rank 0 (None on the others). The blocks of
    one call share a shape (one fraction: the same T and B / k
    everywhere); calls may differ, so nothing about the shape is fixed in
    advance."""
    import torch.distributed as dist
    y = y.contiguous()
    bufs: Optional[List[torch.Tensor]] = None
    if dg.is_coordinator:
        bufs = [torch.empty_like(y) for _ in range(dg.size)]
    dist.gather(y, bufs, dst=0, group=dg.group)
    return torch.cat(bufs, dim=1) if bufs is not None else None
