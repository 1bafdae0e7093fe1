"""Device meshes for sequence parallelism, the subset of the JAX package's
parallel/mesh.py that it needs.

A seq mesh is an ordered list of `torch.device`s: time block i of every
[T, B, ...] array lives on mesh[i]. One process drives every device of it,
as the JAX package's single-controller sequence parallelism does, so no
torch.distributed process group is involved. A mesh may name one device
several times (all blocks on one card, or on the CPU): the port's
counterpart of the JAX tests' forced host devices, which the CPU tests and
chip_smoke.py on one card use. The CLI on CUDA builds a mesh of distinct
GPUs only. Data parallelism runs in processes of its own (data.py,
launch.py); the JAX package's composed_mesh (data parallelism composed
with sequence parallelism) is not ported: config.py refuses --num_devices
other than 1 or --seq_devices, and multi-host runs with --seq_devices.
"""

from __future__ import annotations

from typing import List

import torch


def make_seq_mesh(k: int, device_type: str = "cuda") -> List[torch.device]:
    """The first k GPUs (cuda:0 .. cuda:k-1), refusing more than torch sees
    with the JAX CLI's message; on the CPU, the CPU k times (the JAX
    package sees as many CPU devices as its tests force)."""
    if k < 1:
        raise ValueError(f"a seq mesh needs at least one block, got {k}")
    if device_type == "cpu":
        return [torch.device("cpu")] * k
    if device_type != "cuda":
        raise ValueError(f"a seq mesh runs on cuda or cpu, not {device_type}")
    n_avail = torch.cuda.device_count()
    if k > n_avail:
        raise RuntimeError(
            f"num_devices={k} but only {n_avail} devices available")
    return [torch.device("cuda", i) for i in range(k)]
