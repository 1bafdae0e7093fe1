"""Device meshes for sequence parallelism, alone and composed with data
parallelism: the subset of the JAX package's parallel/mesh.py that they
need.

A seq mesh is an ordered list of `torch.device`s: time block i of every
[T, B, ...] array lives on mesh[i]. One process drives every device of it,
as the JAX package's single-controller sequence parallelism does, so no
torch.distributed process group is involved within a mesh. A mesh may
name one device several times (all blocks on one card, or on the CPU):
the port's counterpart of the JAX tests' forced host devices, which the
CPU tests and chip_smoke.py on one card use. The CLI on CUDA builds a mesh
of distinct GPUs only.

Data parallelism composed with sequence parallelism (DP x SP,
`composed_mesh`) gives each data-parallel rank a seq mesh of its own: the
JAX package's 2-D ('data', 'seq') mesh, whose row j is rank j's group of
consecutive devices. The ranks run in worker processes (parallel/
launch.py), each driving its group's GPUs.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def make_seq_mesh(k: int, device_type: str = "cuda",
                  offset: int = 0) -> List[torch.device]:
    """k consecutive GPUs from cuda:offset (a DP x SP rank's group starts
    at its rank times k), refusing more than torch sees with the JAX CLI's
    message; on the CPU, the CPU k times (the JAX package sees as many CPU
    devices as its tests force)."""
    if k < 1:
        raise ValueError(f"a seq mesh needs at least one block, got {k}")
    if device_type == "cpu":
        return [torch.device("cpu")] * k
    if device_type != "cuda":
        raise ValueError(f"a seq mesh runs on cuda or cpu, not {device_type}")
    n_avail = torch.cuda.device_count()
    if offset + k > n_avail:
        raise RuntimeError(
            f"num_devices={offset + k} but only {n_avail} devices available")
    return [torch.device("cuda", offset + i) for i in range(k)]


def composed_mesh(num_devices: int, k: int, device_type: str = "cuda"
                  ) -> Tuple[List[List[torch.device]], bool]:
    """The seq meshes of a k-way sequence-parallel request over
    num_devices devices of one host, composed with data parallelism when
    the device total exceeds k (lstm_rnn_tpu/parallel/mesh.py:76-93, one
    function for both CLI modes so that their mesh rules cannot drift).

    Returns (meshes, composed): with num_devices > 1 and != k, the
    num_devices / k rank meshes, rank j's on devices j*k .. j*k + k - 1
    (composed=True; k must divide num_devices, refused in the JAX words);
    else the one k-block mesh (composed=False)."""
    if num_devices > 1 and num_devices != k:
        if num_devices % k:
            raise ValueError(
                f"seq_devices={k} must divide num_devices={num_devices}")
        return [make_seq_mesh(k, device_type, j * k)
                for j in range(num_devices // k)], True
    return [make_seq_mesh(k, device_type)], False
