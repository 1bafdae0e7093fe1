"""Device meshes for sequence, pipeline and tensor parallelism, alone and
composed with data parallelism: the subset of the JAX package's
parallel/mesh.py that they need.

A mesh is an ordered list of `torch.device`s: on a seq mesh time block i
of every [T, B, ...] array lives on mesh[i], on a pipe mesh pipeline stage
i runs on mesh[i] (parallel/pipeline.py), on a model mesh device i owns
the i-th slice of every LSTM layer's cells (parallel/tensor.py). One
process drives every device of a mesh, as the JAX package's single
controller does, so no torch.distributed process group is involved within
a mesh. A mesh may name one device several times (all blocks, stages or
shards on one card, or on the CPU): the port's counterpart of the JAX
tests' forced host devices, which the CPU tests and chip_smoke.py on one
card use. The CLI on CUDA builds a mesh of distinct GPUs only.

Data parallelism composed with one of them (DP x SP, DP x PP, DP x TP:
`composed_mesh`) gives each data-parallel rank a mesh of its own: the JAX
package's 2-D ('data', axis) mesh, whose row j is rank j's group of
consecutive devices (`make_mesh_2d`: adjacent devices share a model
group). The ranks run in worker processes (parallel/launch.py), each
driving its group's GPUs.

A seq or pipe mesh may also span processes (`SpanMesh`, `span_mesh`):
the JAX package's 1-D mesh over every process's devices, which its
multi-host CLI trains when the flag's k is the global device count. Each
process drives its own positions, and a hop between two processes goes
over torch.distributed (parallel/hop.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import torch


def make_seq_mesh(k: int, device_type: str = "cuda",
                  offset: int = 0) -> List[torch.device]:
    """k consecutive GPUs from cuda:offset (a composed rank's group starts
    at its rank times k), refusing more than torch sees with the JAX CLI's
    message; on the CPU, the CPU k times (the JAX package sees as many CPU
    devices as its tests force). Every kind of mesh is built here."""
    if k < 1:
        raise ValueError(f"a mesh needs at least one device, got {k}")
    if device_type == "cpu":
        return [torch.device("cpu")] * k
    if device_type != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu, not {device_type}")
    n_avail = torch.cuda.device_count()
    if offset + k > n_avail:
        raise RuntimeError(
            f"num_devices={offset + k} but only {n_avail} devices available")
    return [torch.device("cuda", offset + i) for i in range(k)]


def composed_mesh(num_devices: int, k: int, device_type: str = "cuda",
                  flag: str = "seq_devices"
                  ) -> Tuple[List[List[torch.device]], bool]:
    """The meshes of a k-way sequence-, pipeline- or tensor-parallel
    request over num_devices devices of one host, composed with data
    parallelism when the device total exceeds k (lstm_rnn_tpu/parallel/
    mesh.py:58-93: `composed_mesh` for --seq_devices and
    --pipeline_devices, `make_mesh_2d` for --model_devices; one function
    for every flag and both CLI modes, so that their mesh rules cannot
    drift). `flag` names the option in the divisibility error.

    Returns (meshes, composed): with num_devices > 1 and != k, the
    num_devices / k rank meshes, rank j's on devices j*k .. j*k + k - 1
    (composed=True; k must divide num_devices, refused in the JAX words);
    else the one k-device mesh (composed=False)."""
    if num_devices > 1 and num_devices != k:
        if num_devices % k:
            raise ValueError(
                f"{flag}={k} must divide num_devices={num_devices}")
        return [make_seq_mesh(k, device_type, j * k)
                for j in range(num_devices // k)], True
    return [make_seq_mesh(k, device_type)], False


@dataclasses.dataclass(frozen=True)
class SpanMesh:
    """A 1-D seq or pipe mesh that spans processes: the JAX package's mesh
    over every process's devices in process-major order (lstm_rnn_tpu/
    parallel/mesh.py `global_devices`), held by one of its processes.
    Process r owns the positions `offsets[r] .. offsets[r] + counts[r] -
    1`, one a local device. `devices[i]` is position i's device where
    this process owns it, None where another does; `owners[i]` is the
    rank that owns it. `groups` holds the torch.distributed groups of the
    hops (parallel/hop.py `new_groups`: one a direction of travel), None
    until the worker has made them.

    Indexing and len() read it as a mesh; code that places work on its
    devices asks `owns(i)` first."""
    axis: str
    rank: int
    owners: tuple
    devices: tuple
    groups: Any = None

    def __len__(self) -> int:
        return len(self.devices)

    def __getitem__(self, i):
        return self.devices[i]

    def owns(self, i: int) -> bool:
        return self.owners[i] == self.rank

    @property
    def local(self) -> List[torch.device]:
        """This process's devices, in mesh order."""
        return [d for d in self.devices if d is not None]

    @property
    def home(self) -> torch.device:
        """The first owned position's device: where the parameters, the
        gradients and this process's share of the loss live."""
        return self.local[0]


def span_mesh(axis: str, counts: Sequence[int], rank: int,
              local: Sequence[torch.device]) -> SpanMesh:
    """The spanning mesh of `axis` as process `rank` holds it: counts[r]
    positions for process r, in rank order, this process's on `local`
    (its devices, len(local) == counts[rank])."""
    if len(local) != counts[rank]:
        raise ValueError(f"process {rank} posted {counts[rank]} devices but "
                         f"holds {len(local)}")
    owners = tuple(r for r, n in enumerate(counts) for _ in range(n))
    off = sum(counts[:rank])
    devices = [None] * len(owners)
    devices[off:off + len(local)] = [torch.device(d) for d in local]
    return SpanMesh(axis, rank, owners, tuple(devices))


class _Hop(torch.autograd.Function):
    """x.to(device) from one GPU to another, whose backward copies the
    gradient back with x's GPU's current stream set to the stream that
    was current there in the forward. Autograd runs the backward on the
    thread of the gradient's GPU, where x's GPU's current stream is its
    default stream; under a step graph's capture (graphs.py) that stream
    is not capturing, and the copy's allocation and its barrier must land
    in the capture. Eagerly it is the stream the plain copy uses."""

    @staticmethod
    def forward(ctx, x, device, non_blocking):
        ctx.src = x.device
        ctx.stream = torch.cuda.current_stream(x.device)
        return x.to(device, non_blocking=non_blocking)

    @staticmethod
    def backward(ctx, g):
        with torch.cuda.stream(ctx.stream):
            return g.to(ctx.src), None, None


def move(x: torch.Tensor, device, non_blocking: bool = False):
    """x on `device`, differentiably: `x.to(device)`, between two GPUs
    through `_Hop`."""
    device = torch.device(device)
    if (x.device.type == device.type == "cuda" and device.index is not None
            and device.index != x.device.index):
        return _Hop.apply(x, device, non_blocking)
    return x.to(device, non_blocking=non_blocking)
