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
"""

from __future__ import annotations

from typing import List, Tuple

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
