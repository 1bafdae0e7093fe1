"""A multi-host run's coordinator, process count, rank and local devices,
resolved from the flags and the cluster's environment.

Counterpart of lstm_rnn_tpu/parallel/distributed.py's `maybe_initialize`
and of the resolution `jax.distributed.initialize` makes before it joins
the processes (jax/_src/distributed.py, jax/_src/clusters/cluster.py,
ompi_cluster.py, slurm_cluster.py), in that order:

- the coordinator: `--coordinator_address`, else `JAX_COORDINATOR_ADDRESS`.
  With neither the run is single-host, whatever else the environment
  holds. No address is derived from the cluster alone: the JAX CLI
  returns before jax could (distributed.py:46-47);
- the local devices: `JAX_LOCAL_DEVICE_IDS`, a comma list, if set;
- then, while the count, the rank or the local devices are still
  unknown, the first cluster whose variables are present fills in what
  is missing: Open MPI (`OMPI_MCA_orte_hnp_uri` set by mpirun or mpiexec;
  `OMPI_COMM_WORLD_SIZE`, `_RANK`, `_LOCAL_RANK`), else SLURM (all of
  `SLURM_JOB_ID`, `SLURM_STEP_NODELIST`, `SLURM_NTASKS`, `SLURM_PROCID`,
  `SLURM_LOCALID`). An explicit flag (`--num_processes` >= 1,
  `--process_id` >= 0) always wins. The cluster's local rank becomes the
  one local device, as jax sets `local_device_ids = [local rank]`;
- a coordinator with no count or no rank from anywhere is refused in
  jax's words.

The Kubernetes probe (it needs the `kubernetes` package), the opt-in
mpi4py probe and the Cloud TPU probes are not ported (ROADMAP.md, "Not to
port").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional, Tuple

# Open MPI's, then SLURM's: (the variables whose presence selects it,
# count, rank, local rank)
CLUSTERS = (
    (("OMPI_MCA_orte_hnp_uri",), "OMPI_COMM_WORLD_SIZE",
     "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"),
    (("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
      "SLURM_PROCID", "SLURM_LOCALID"),
     "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"),
)


@dataclasses.dataclass(frozen=True)
class Cluster:
    """What a run resolved: the coordinator ("" for a single-host run),
    the process count and this process's rank (0 and -1 when
    single-host), and the local device ids the process is bound to
    (None: every local device)."""
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1
    local_device_ids: Optional[Tuple[int, ...]] = None


def resolve(coordinator_address: str = "", num_processes: int = 0,
            process_id: int = -1,
            environ: Optional[Mapping[str, str]] = None) -> Cluster:
    """The run's Cluster from the flags' values (0 and -1: not given) and
    the environment (default os.environ)."""
    env = os.environ if environ is None else environ
    coord = coordinator_address or env.get("JAX_COORDINATOR_ADDRESS", "")
    if not coord:
        return Cluster(num_processes=num_processes, process_id=process_id)
    count = num_processes if num_processes >= 1 else None
    rank = process_id if process_id >= 0 else None
    ids = env.get("JAX_LOCAL_DEVICE_IDS") or None
    if ids is not None:
        ids = tuple(int(i) for i in ids.split(",") if i != "")
    if None in (count, rank, ids):
        for present, n_var, r_var, l_var in CLUSTERS:
            if all(v in env for v in present):
                count = int(env[n_var]) if count is None else count
                rank = int(env[r_var]) if rank is None else rank
                if ids is None:
                    ids = (int(env[l_var]),)
                break
    where = ("--coordinator_address" if coordinator_address
             else "JAX_COORDINATOR_ADDRESS")
    if count is None:
        raise ValueError(
            f"Number of processes must be defined: {where} is set, but "
            "neither --num_processes N nor Open MPI's OMPI_COMM_WORLD_SIZE "
            "nor SLURM's SLURM_NTASKS gives the count")
    if rank is None:
        raise ValueError(
            f"The process id of the current process must be defined: "
            f"{where} is set, but neither --process_id nor Open MPI's "
            "OMPI_COMM_WORLD_RANK nor SLURM's SLURM_PROCID gives it")
    return Cluster(coord, count, rank, ids)
