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
  --process_id i` (or what parallel/cluster.py resolves from
  JAX_COORDINATOR_ADDRESS and Open MPI's or SLURM's variables): the
  process on each host starts one worker per local GPU (one on the CPU),
  per GPU it is bound to (`Config.local_device_ids`: its cluster local
  rank's, one worker on cuda:{local rank}, as jax binds such a process
  to that one device), or with a mesh of k (--seq_devices,
  --pipeline_devices, --model_devices in train mode) one per group of k
  local GPUs (L / k of L; one CPU worker on the CPU), and
  `--num_devices` is ignored, as in the JAX CLI: every process's devices
  take part. Global rank = i * local + j, world = N * local, so rank
  order is process-major: each host owns a contiguous block of B and
  every group, with its hops, stays inside a host. Process 0 serves the
  rendezvous store at the coordinator's port; every process posts its
  local worker count there, and a host whose count differs from the
  others' is refused by name before any worker starts.
- A seq or pipe mesh over every host (train mode; the JAX package's 1-D
  mesh over `global_devices`, lstm_rnn_tpu/parallel/mesh.py:30-34):
  with the multi-host flags and --seq_devices or --pipeline_devices k
  not dividing a host's L, where k is the global device count, each
  process starts ONE worker, which drives its L GPUs as positions
  off_i .. off_i + L_i - 1 of the one mesh (process-major; the hosts may
  differ in size, so this plan alone lifts the same-count check). Each
  process posts its L, and the rendezvous refuses the span by name unless
  the counts add up to k. The worker's DataGroup holds the mesh
  (`DataGroup.span`, parallel/mesh.py `SpanMesh`) with the hops' process
  groups (parallel/hop.py). A composed group whose row would cross a host
  (k not dividing L and short of the global count) and tensor
  parallelism across hosts are refused by name before any worker starts:
  the JAX package fails there too (mesh.py:132, "Invalid host data").
  `local_devices` gives a process its devices (every GPU torch sees; on
  the CPU the CPU k times, which a test may replace).
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
cuda:0 over gloo that way, each with a mesh of cuda:0 twice); with
`span=True` the lists are the workers' parts of one spanning mesh.
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

from lstm_rnn_tpu_torch.parallel import hop
from lstm_rnn_tpu_torch.parallel.data import DataGroup
from lstm_rnn_tpu_torch.parallel.mesh import composed_mesh, span_mesh

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
    no mesh). With `span` = k > 0 the workers' meshes are their parts of
    one k-position seq or pipe mesh over every process (worker j's part
    `meshes[j]`, in rank order): one worker a process in a multi-host
    run. `timeout_s` bounds every collective, hop and wait of the run
    (0: TIMEOUT_S)."""
    devices: tuple
    hosts: int = 1
    process_id: int = 0
    addr: Optional[tuple] = None
    meshes: Optional[tuple] = None
    axis: str = "seq"
    span: int = 0
    timeout_s: float = 0.0

    @property
    def world(self) -> int:
        return len(self.devices) * self.hosts

    @property
    def local_count(self) -> int:
        """What this process posts at the rendezvous: its worker count, or
        under a span its devices (the positions it owns)."""
        return len(self.meshes[0]) if self.span else len(self.devices)


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


def local_devices(device_type: str, k: int = 1) -> List[torch.device]:
    """This process's devices in a multi-host run: every GPU torch sees;
    on the CPU, the CPU k times (a mesh's worth, so that a process is one
    CPU worker with its own mesh). A test that wants a CPU process of
    another shape replaces this function."""
    if device_type == "cpu":
        return [torch.device("cpu")] * k
    return [torch.device("cuda", j) for j in range(torch.cuda.device_count())]


def _bound(ids, device: torch.device) -> Optional[List[torch.device]]:
    """The GPUs a multi-host process is bound to (parallel/cluster.py:
    its cluster local rank's, or JAX_LOCAL_DEVICE_IDS), or None: every
    local device. On the CPU a bound process is one CPU worker, as an
    unbound one is."""
    if not ids or device.type != "cuda":
        return None
    n_avail = torch.cuda.device_count()
    if max(ids) >= n_avail:
        raise RuntimeError(f"local device ids {list(ids)} but only "
                           f"{n_avail} devices available")
    return [torch.device("cuda", i) for i in ids]


def _spans(axis: str, k: int, n: int, hosts: int) -> bool:
    """Whether a multi-host run's k-position mesh of `axis` over hosts of
    n local devices (this one's) spans every host, the one cross-host
    layout the JAX package trains; refuses the others by name. A spanning
    k is the global device count, which the rendezvous checks: every host
    holds at least one device, so k >= n + hosts - 1 here."""
    if not n % k:
        return False  # whole groups on every host
    refused = (f"--{FLAGS[axis]} {k} over a host of {n} devices would put "
               f"a {axis} group across hosts")
    if axis == "model":
        raise ValueError(
            f"{refused}: tensor parallelism across hosts, where the JAX "
            "package fails too (lstm_rnn_tpu/parallel/mesh.py:132, "
            "'Invalid host data': its TP mesh is always 2-D); see "
            "ROADMAP.md (Not to port)")
    if k < n + hosts - 1:
        raise ValueError(
            f"{refused} inside a composed ('data', '{axis}') mesh, where "
            "the JAX package fails too (lstm_rnn_tpu/parallel/mesh.py:132, "
            f"'Invalid host data'); a {axis} group crosses hosts only as "
            "one 1-D mesh over every host's devices (k = the global device "
            "count); see ROADMAP.md (Not to port)")
    return True


def plan(cfg, device: torch.device) -> Optional[Plan]:
    """The run's workers, or None for a run in this process (no group: one
    device, or a 1-D seq, pipe or model mesh). `device` is the device the
    CLI selected (its type picks GPUs or CPU workers)."""
    multihost = bool(cfg.coordinator_address)
    axis, k = mesh_axis(cfg)
    if multihost:
        local = _bound(cfg.local_device_ids, device) or local_devices(
            device.type, k)
        n = len(local)
    elif device.type == "cpu":
        n = max(1, cfg.num_devices)
    else:
        n_avail = torch.cuda.device_count()
        n = n_avail if cfg.num_devices == 0 else cfg.num_devices
        if n > n_avail:
            raise RuntimeError(
                f"num_devices={n} but only {n_avail} devices available")
    meshes = None
    if axis is not None:
        if multihost and _spans(axis, k, n, cfg.num_processes):
            # one worker drives this host's part of the one mesh
            return Plan((local[0],), hosts=cfg.num_processes,
                        process_id=cfg.process_id,
                        addr=_coordinator(cfg.coordinator_address),
                        meshes=(tuple(local),), axis=axis, span=k)
        groups, composed = composed_mesh(n, k, device.type, FLAGS[axis])
        if not (composed or multihost):
            return None  # the 1-D mesh, in this process
        if multihost and device.type == "cuda":  # the process's own GPUs
            groups = [[local[d.index] for d in m] for m in groups]
        meshes = tuple(tuple(m) for m in groups)
        devices = tuple(m[0] for m in meshes)
    elif multihost:
        devices = tuple(local)
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


def _timeout(p: Optional[Plan] = None):
    return datetime.timedelta(seconds=p.timeout_s if p and p.timeout_s
                              else TIMEOUT_S)


def _serve_store(p: Plan):
    """The rendezvous store: a loopback one on a free port for one host;
    for several, process 0 serves it at the coordinator's port and the
    others connect. Every process posts its local device count and host
    name (`Plan.local_count`), and all of them check that the counts
    agree, or under a span that they add up to its k. Returns (store,
    addr, counts): counts[r] the positions rank r owns under a span (its
    mesh part's length on one host), else None."""
    import torch.distributed as dist
    if p.addr is None:
        store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                              wait_for_workers=False, timeout=_timeout(p))
        counts = [len(m) for m in p.meshes] if p.span else None
        if counts is not None and sum(counts) != p.span:
            raise ValueError(f"a span of {p.span} positions was given "
                             f"parts of {counts}")
        return store, ("127.0.0.1", store.port), counts
    host, port = p.addr
    store = dist.TCPStore(host, port, None, is_master=p.process_id == 0,
                          wait_for_workers=False, timeout=_timeout(p))
    store.set(f"host/{p.process_id}",
              f"{p.local_count} {socket.gethostname()}")
    keys = [f"host/{i}" for i in range(p.hosts)]
    store.wait(keys, _timeout(p))
    counts = {}
    for i, key in enumerate(keys):
        n, name = store.get(key).decode().split(" ", 1)
        counts[i] = (int(n), name)
    # process 0 serves the store until every process has read the counts
    store.set(f"read/{p.process_id}", "1")
    if p.process_id == 0:
        store.wait([f"read/{i}" for i in range(p.hosts)], _timeout(p))
    hosts = ", ".join(f"process {i} on {name} has {n}"
                      for i, (n, name) in sorted(counts.items()))
    if p.span:
        if sum(n for n, _ in counts.values()) != p.span:
            raise RuntimeError(
                f"--{FLAGS[p.axis]} {p.span} over hosts of "
                f"{sum(n for n, _ in counts.values())} devices in all: a "
                f"{p.axis} group across hosts must span every host's "
                f"devices, and no composed mesh may cross a host (the JAX "
                "package fails there too, lstm_rnn_tpu/parallel/"
                f"mesh.py:132): {hosts}")
        return store, p.addr, [counts[i][0] for i in range(p.hosts)]
    if len({n for n, _ in counts.values()}) > 1:
        raise RuntimeError(
            "every host of a multi-host run must have the same number of "
            "devices: " + hosts)
    return store, p.addr, None


def _die_with_parent() -> None:
    """Have the kernel kill this worker when its launcher dies (Linux), so
    that no worker outlives a killed run."""
    try:
        import ctypes
        import signal
        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _worker(j: int, p: Plan, addr, counts, backend: str, fn: Callable,
            args):
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
                          timeout=_timeout(p))
    dist.init_process_group(backend, store=dist.PrefixStore("dp", store),
                            rank=rank, world_size=p.world,
                            timeout=_timeout(p))
    try:
        if p.span:
            # the hops' groups first: every rank makes them in this order
            span = dataclasses.replace(
                span_mesh(p.axis, counts, rank, p.meshes[j]),
                groups=hop.new_groups(backend, _timeout(p)))
            mesh = {"span": span}
        else:
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
    store, addr, counts = _serve_store(p)
    sys.stdout.flush()
    sys.stderr.flush()
    try:
        mp.spawn(_worker, args=(p, addr, counts, backend, fn, tuple(args)),
                 nprocs=len(p.devices), join=True, daemon=True)
    except ProcessException as e:
        if store.check(["first_failure"]):
            rank, tb = store.get("first_failure").decode().split("\n", 1)
            raise WorkerError(int(rank), tb) from e
        raise


def start(fn: Callable, devices: Sequence, args=(),
          backend: Optional[str] = None, axis: str = "seq",
          span: bool = False, timeout_s: float = 0.0) -> None:
    """Run fn(group, *args) in len(devices) workers of one host, worker j
    on devices[j]: a device, or a mesh of `axis` "seq", "pipe" or "model"
    (a list of devices, every entry a list: worker j on its mesh's first
    device). With `span`, the lists are the workers' parts of one seq or
    pipe mesh in rank order (group.span: each worker the processes' hops
    of a mesh over several hosts). A device may repeat: then the backend
    must be gloo. `timeout_s` (0: TIMEOUT_S) bounds every wait of the
    run."""
    if all(isinstance(d, (list, tuple)) for d in devices):
        meshes = tuple(tuple(torch.device(x) for x in m) for m in devices)
        launch(Plan(tuple(m[0] for m in meshes), meshes=meshes, axis=axis,
                    span=sum(map(len, meshes)) if span else 0,
                    timeout_s=timeout_s), fn, args, backend)
    else:
        launch(Plan(tuple(torch.device(d) for d in devices),
                    timeout_s=timeout_s), fn, args, backend)


def _cli_worker(group: DataGroup, body: Callable, cfg) -> int:
    return body(cfg, group.device, group)


def run(cfg, device: torch.device, body: Callable) -> int:
    """The CLI's mode `body(cfg, device[, group])`: in this process on one
    device or a 1-D mesh, or data-parallel in a worker per device (or
    mesh) of plan(cfg, device)."""
    p = plan(cfg, device)
    if p is None:
        return body(cfg, device)
    total = p.span or p.world
    if p.hosts > 1 and cfg.num_devices not in (0, 1, total):
        print(f"Multi-host run spans all {total} global devices "
              "(--num_devices ignored: every process must participate)")
    launch(p, _cli_worker, (body, cfg))
    return 0
