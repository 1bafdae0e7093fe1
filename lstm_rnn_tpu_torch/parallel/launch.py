"""Starting the workers of a data-parallel run.

Counterpart of lstm_rnn_tpu/parallel/distributed.py's `maybe_initialize`
and of the JAX CLI's mesh setup (lstm_rnn_tpu/cli.py:36-50, :303-378,
:507-533). Where the JAX package runs one process per host and lets XLA
drive every local chip, the port runs one worker process per device
(`torch.multiprocessing`, start method spawn): a host thread cannot keep
several GPUs fed, so each GPU gets its own.

- `--num_devices k` on one host: k workers, worker j on cuda:j (on the
  CPU with `--device cpu`: k CPU workers, the port's counterpart of the
  JAX tests' forced host devices). 0 means every GPU torch sees; more
  than torch sees is refused with the JAX CLI's message.
- `--num_devices n --seq_devices sp` (DP x SP): with n 1 or sp, the run
  stays one process on a 1-D seq mesh (no worker). Otherwise sp must
  divide n (refused in the JAX words) and n / sp workers start, worker j
  driving the seq mesh cuda:j*sp .. cuda:j*sp+sp-1 (parallel/mesh.py
  `composed_mesh`), its current device and NCCL's the mesh's first; on
  the CPU, n / sp CPU workers, each with the CPU named sp times.
- `--num_devices n --pipeline_devices k` (DP x PP, both modes) and, in
  train mode, `--num_devices n --model_devices k` (DP x TP) start workers
  the same way: with n 1 or k (model: n == k) the run stays one process
  on a 1-D pipe or model mesh; otherwise k must divide n and worker j
  drives the mesh cuda:j*k .. cuda:j*k+k-1. Forward mode ignores
  --model_devices, as the JAX CLI's forward mode never reads it.
- Multi-host, `--coordinator_address host:port --num_processes N
  --process_id i`: the process on each host starts one worker per local
  GPU (one on the CPU), or with a mesh of k (--seq_devices,
  --pipeline_devices, --model_devices in train mode) one per group of k
  local GPUs (L / k of L; one CPU worker on the CPU), and
  `--num_devices` is ignored, as in the JAX CLI: every process's devices
  take part. Global rank = i * local + j, world = N * local, so rank
  order is process-major: each host owns a contiguous block of B and
  every group, with its hops, stays inside a host. A group that would
  span hosts (k not dividing L) is refused by name: one process cannot
  drive another host's GPUs. Process 0 serves the
  rendezvous store at the coordinator's port; every process posts its
  local worker count there, and a host whose count differs from the
  others' is refused by name before any worker starts.
- The group's backend is NCCL on CUDA and gloo on the CPU; there is no
  fallback. The kernel library is built once, in the launching process,
  before the workers start.
- A worker that raises ends the run: the launcher terminates the other
  local workers and raises `WorkerError` with the traceback of the first
  worker that failed (the others then fail on its absence; the CLI exits
  non-zero). The process group has a timeout, so a worker waiting
  on a host that died fails instead of hanging; a worker dies with its
  launcher.

`run(cfg, device, body)` is the CLI's entry: it calls `body(cfg, device)`
in this process when the run has no worker, else `body(cfg,
group.device, group)` in every worker (`group`: parallel/data.py's
DataGroup, with the worker's seq, pipe or model mesh). `start(fn,
devices, backend, axis)` runs `fn(group, *args)` in one worker per entry
of a list, a device or a mesh (a list of devices) of the given axis,
which may name one device several times (chip_smoke.py runs two ranks on
cuda:0 over gloo that way, each with a mesh of cuda:0 twice).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import sys
import traceback
from typing import Callable, List, Optional, Sequence

import torch

from lstm_rnn_tpu_torch.parallel.data import DataGroup
from lstm_rnn_tpu_torch.parallel.mesh import composed_mesh

# seconds a collective, the rendezvous or a host's arrival may take before
# the run fails
TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Plan:
    """Where a run's workers go: a worker per entry of `devices` on each
    of `hosts` processes, this one `process_id`, the store at `addr`
    (host, port; None: a loopback store of this process). Under DP x SP,
    DP x PP or DP x TP, `meshes[j]` is worker j's mesh of the `axis`
    "seq", "pipe" or "model", whose first device is `devices[j]` (None:
    no mesh)."""
    devices: tuple
    hosts: int = 1
    process_id: int = 0
    addr: Optional[tuple] = None
    meshes: Optional[tuple] = None
    axis: str = "seq"

    @property
    def world(self) -> int:
        return len(self.devices) * self.hosts


class WorkerError(RuntimeError):
    """A worker of the run raised: the first one that did, by global rank,
    with its exception's last line; `worker_traceback` holds the rest."""

    def __init__(self, rank: int, worker_traceback: str):
        lines = worker_traceback.strip().splitlines() or ["(no traceback)"]
        super().__init__(f"rank {rank}: {lines[-1]}")
        self.rank = rank
        self.worker_traceback = worker_traceback


def _coordinator(address: str):
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"--coordinator_address must be host:port, got "
                         f"'{address}'")
    return host.strip("[]"), int(port)


# the rank mesh's axis -> its flag
FLAGS = {"seq": "seq_devices", "pipe": "pipeline_devices",
         "model": "model_devices"}


def mesh_axis(cfg):
    """(axis, k) of the run's mesh: --seq_devices, --pipeline_devices or,
    in train mode, --model_devices above 1 (the config refuses two of
    them together); (None, 1) without."""
    for axis, k in (("seq", cfg.seq_devices),
                    ("pipe", cfg.pipeline_devices),
                    ("model", cfg.model_devices if cfg.train else 1)):
        if k > 1:
            return axis, k
    return None, 1


def plan(cfg, device: torch.device) -> Optional[Plan]:
    """The run's workers, or None for a run in this process (no group: one
    device, or a 1-D seq, pipe or model mesh). `device` is the device the
    CLI selected (its type picks GPUs or CPU workers)."""
    multihost = bool(cfg.coordinator_address)
    axis, k = mesh_axis(cfg)
    if device.type == "cpu":
        # a multi-host process is one CPU worker (the CPU k times with a
        # mesh)
        n = k if multihost else max(1, cfg.num_devices)
    else:
        n_avail = torch.cuda.device_count()
        n = n_avail if multihost or cfg.num_devices == 0 else cfg.num_devices
        if n > n_avail:
            raise RuntimeError(
                f"num_devices={n} but only {n_avail} devices available")
    meshes = None
    if axis is not None:
        if multihost and n % k:
            raise ValueError(
                f"--{FLAGS[axis]} {k} over a host of {n} devices would put "
                f"a {axis} group across hosts, which the PyTorch port does "
                "not support; see ROADMAP.md (parallelism, a cross-host "
                f"{axis} group)")
        groups, composed = composed_mesh(n, k, device.type, FLAGS[axis])
        if not (composed or multihost):
            return None  # the 1-D mesh, in this process
        meshes = tuple(tuple(m) for m in groups)
        devices = tuple(m[0] for m in meshes)
    elif device.type == "cpu":
        devices = (torch.device("cpu"),) * n
    else:
        devices = tuple(torch.device("cuda", j) for j in range(n))
    axis = axis or "seq"
    if not multihost:
        return (Plan(devices, meshes=meshes, axis=axis) if len(devices) > 1
                else None)
    return Plan(devices, hosts=cfg.num_processes, process_id=cfg.process_id,
                addr=_coordinator(cfg.coordinator_address), meshes=meshes,
                axis=axis)


def _timeout():
    return datetime.timedelta(seconds=TIMEOUT_S)


def _serve_store(p: Plan):
    """The rendezvous store: a loopback one on a free port for one host;
    for several, process 0 serves it at the coordinator's port and the
    others connect. Every process posts its local device count and host
    name, and all of them check that the counts agree. Returns (store,
    addr)."""
    import torch.distributed as dist
    if p.addr is None:
        store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                              wait_for_workers=False, timeout=_timeout())
        return store, ("127.0.0.1", store.port)
    host, port = p.addr
    store = dist.TCPStore(host, port, None, is_master=p.process_id == 0,
                          wait_for_workers=False, timeout=_timeout())
    store.set(f"host/{p.process_id}",
              f"{len(p.devices)} {socket.gethostname()}")
    keys = [f"host/{i}" for i in range(p.hosts)]
    store.wait(keys, _timeout())
    counts = {}
    for i, key in enumerate(keys):
        n, name = store.get(key).decode().split(" ", 1)
        counts[i] = (int(n), name)
    # process 0 serves the store until every process has read the counts
    store.set(f"read/{p.process_id}", "1")
    if p.process_id == 0:
        store.wait([f"read/{i}" for i in range(p.hosts)], _timeout())
    if len({n for n, _ in counts.values()}) > 1:
        raise RuntimeError(
            "every host of a multi-host run must have the same number of "
            "devices: " + ", ".join(
                f"process {i} on {name} has {n}"
                for i, (n, name) in sorted(counts.items())))
    return store, p.addr


def _die_with_parent() -> None:
    """Have the kernel kill this worker when its launcher dies (Linux), so
    that no worker outlives a killed run."""
    try:
        import ctypes
        import signal
        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _worker(j: int, p: Plan, addr, backend: str, fn: Callable, args):
    import torch.distributed as dist
    _die_with_parent()
    rank = p.process_id * len(p.devices) + j
    device = p.devices[j]  # with a mesh, its first
    if rank != 0:  # rank 0 prints; the others stay silent
        sys.stdout = open(os.devnull, "w")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the host's cores, shared among its CPU workers
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // len(p.devices)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    store = dist.TCPStore(addr[0], addr[1], None, is_master=False,
                          timeout=_timeout())
    dist.init_process_group(backend, store=dist.PrefixStore("dp", store),
                            rank=rank, world_size=p.world,
                            timeout=_timeout())
    try:
        mesh = {f"{p.axis}_mesh": p.meshes[j]} if p.meshes else {}
        rc = fn(DataGroup(rank, p.world, device, hosts=p.hosts, **mesh),
                *args)
        if rc:
            raise RuntimeError(f"rank {rank} returned {rc}")
        dist.barrier()
    except BaseException:
        # the first failure of the run is its cause: the others follow it
        tb = traceback.format_exc()
        try:
            if store.add("failed", 1) == 1:
                store.set("first_failure", f"{rank}\n{tb}")
        except RuntimeError:  # the store's host is gone: report this one
            pass
        raise
    finally:
        dist.destroy_process_group()


def _backend(devices: Sequence[torch.device]) -> str:
    return "nccl" if devices[0].type == "cuda" else "gloo"


def launch(p: Plan, fn: Callable, args=(), backend: Optional[str] = None
           ) -> None:
    """Run fn(group, *args) in one spawned worker per device of the plan
    and wait for all of them; raises (after terminating the others) when
    one fails. Builds the kernel library first when the workers use
    GPUs."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    backend = backend or _backend(p.devices)
    if p.devices[0].type == "cuda":
        from lstm_rnn_tpu_torch.ops import _build
        _build.load()
    # held until the workers are done: process 0's store serves them all
    store, addr = _serve_store(p)
    sys.stdout.flush()
    sys.stderr.flush()
    try:
        mp.spawn(_worker, args=(p, addr, backend, fn, tuple(args)),
                 nprocs=len(p.devices), join=True, daemon=True)
    except ProcessException as e:
        if store.check(["first_failure"]):
            rank, tb = store.get("first_failure").decode().split("\n", 1)
            raise WorkerError(int(rank), tb) from e
        raise


def start(fn: Callable, devices: Sequence, args=(),
          backend: Optional[str] = None, axis: str = "seq") -> None:
    """Run fn(group, *args) in len(devices) workers of one host, worker j
    on devices[j]: a device, or a mesh of `axis` "seq", "pipe" or "model"
    (a list of devices, every entry a list: worker j on its mesh's first
    device). A device may repeat: then the backend must be gloo."""
    if all(isinstance(d, (list, tuple)) for d in devices):
        meshes = tuple(tuple(torch.device(x) for x in m) for m in devices)
        launch(Plan(tuple(m[0] for m in meshes), meshes=meshes, axis=axis),
               fn, args, backend)
    else:
        launch(Plan(tuple(torch.device(d) for d in devices)), fn, args,
               backend)


def _cli_worker(group: DataGroup, body: Callable, cfg) -> int:
    return body(cfg, group.device, group)


def run(cfg, device: torch.device, body: Callable) -> int:
    """The CLI's mode `body(cfg, device[, group])`: in this process on one
    device or a 1-D mesh, or data-parallel in a worker per device (or
    mesh) of plan(cfg, device)."""
    p = plan(cfg, device)
    if p is None:
        return body(cfg, device)
    if p.hosts > 1 and cfg.num_devices not in (0, 1, p.world):
        print(f"Multi-host run spans all {p.world} global devices "
              "(--num_devices ignored: every process must participate)")
    launch(p, _cli_worker, (body, cfg))
    return 0
