"""Step graphs: the H100's counterpart of the JAX Trainer's fused fraction
groups (lstm_rnn_tpu/trainer.py `train_scan` / `eval_scan`).

On the TPU a group of K same-shape fractions ran as one jitted fori_loop:
one dispatch instead of K. On the H100 one step is hundreds of kernel
launches issued from Python, and the counterpart of "one dispatch" is a
CUDA graph of the step: captured once per fraction shape and mode (train
or eval), then replayed for every further fraction of that shape. Every
kernel in it is one the step launches eagerly: the LSTM and tail kernels,
the GEMM engine, the SGD update's elementwise ops.

A `StepGraph`:
- owns static buffers for the fraction's (inputs, targets, pattypes). Each
  step first copies its fraction into them, device to device: from the
  staging copy, from a cache hit or from a row of a stacked epoch;
- runs the first fraction of its shape eagerly on a side stream. That is
  the warm-up torch asks for before a capture, and it is the fraction's
  real step: it also builds the kernel library and settles the kernels'
  cluster plans. The capture comes on the shape's next fraction, followed
  by its replay, so no step runs twice and none is skipped;
- copies each replay's (err, correct) out of the graph's outputs, which
  the next replay overwrites;
- captures into a memory pool of its own: bucketed shapes replay in
  shuffled order, so torch's rule for a shared pool (replay in capture
  order) does not hold;
- steps eagerly when the capture would not fit in free memory with room
  left for one more eager step: its own pool and the largest warm-up's
  peak (a warm-up's peak is what it allocated above its start) against
  the free bytes. It names the shape through `note`;
- counts its warm-ups, captures, replays and eager steps in a
  `GraphStats`, with each capture's seconds, pool bytes, replays and the
  kernel launches that the port's wrappers counted while it recorded
  them. A replay calls no wrapper, so the wrappers' counters see a
  graph's kernels once, at its capture; `GraphStats.executed` gives the
  launches that ran, each capture's recorded ones counted once a replay.

A step may hold a data group's collective and the work of several GPUs
(trainer.py: DP, the one-process seq, pipe and model meshes, DP x SP,
DP x PP and DP x TP, and a seq or pipe mesh across processes over
NCCL). A graph then
- captures the packed all-reduce (parallel/data.py `all_reduce_sum`) on
  NCCL: ProcessGroupNCCL joins its stream to the capture through events,
  and the warm-up's eager collective has created the communicator before
  any capture. Every rank captures at the same step (they see the same
  fractions) and replays in the same order; a rank that steps eagerly
  (`_fits`) issues the same one collective a step. `all_reduce_sum`'s
  count sees a captured collective once, so it is recorded among the
  capture's launches ("collectives") and `GraphStats.executed` counts it
  once a replay. The hops of a mesh across processes (parallel/hop.py's
  NCCL sends and receives) land in the capture the same way, and their
  counts ("hop:<kind>") are recorded among the capture's launches too;
- holds a model mesh's TP kernels (ops/lstm_tp.py), one K8 launch a
  layer and GPU on the mesh context's stream of that GPU, which joins
  the capture through events: each launch depends only on work issued
  before all of the layer's launches, and their flags survive replays;
- spans every GPU of the mesh (`devices`, the graph's own first): each
  other GPU's current stream is a side stream that forks from the
  capture stream and joins it again at the end (`_mesh_streams`), so
  that its kernels, the blocks' carry and parameter copies and the stage
  messages land in the capture and nothing is issued to a device's
  legacy default stream; allocations on each other GPU go to a private
  pool of its own (torch's graph pool covers the capture device only),
  released with the graph (`release`). Autograd runs a GPU's backward on
  a thread of its own, whose current stream on every other GPU is the
  default one: the mesh paths' copies between GPUs go through
  parallel/mesh.py `move`, whose backward sets it to the forward's
  stream, so that those copies land in the capture too. The warm-up runs on the same
  arrangement of side streams; `_fits` checks every GPU of the mesh and
  `pool_bytes` sums their pools. A replay waits for the other GPUs'
  current streams and they wait for it.

A capture or replay that fails raises; nothing falls back to the eager
step on the card. On the CPU there are no graphs: the Trainer runs the
same steps eagerly (trainer.py `_fused_step`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


class _Collectives:
    """parallel/data.py `all_reduce_sum`'s count of the collectives it
    issued, read as a launch counter."""

    @property
    def launches(self) -> int:
        from lstm_rnn_tpu_torch.parallel.data import all_reduce_sum
        return all_reduce_sum.collectives


class _Hops:
    """parallel/hop.py's count of one kind of message this process sent
    or received (`hop.COUNTS`), read as a launch counter."""

    def __init__(self, kind: str):
        self.kind = kind

    @property
    def launches(self) -> int:
        from lstm_rnn_tpu_torch.parallel import hop
        return hop.COUNTS[self.kind]


def launch_counters() -> Dict[str, object]:
    """Every launch counter of the port's kernels, found in ops/: each
    object of ops/lstm_cell.py, ops/lstm_tp.py and ops/softmax_ce.py with
    an integer `.launches` (the wrappers, the 3x counts) and the GEMM
    engine's per-product counters (ops/gemm.py `LAUNCHES`, as
    "gemm:<use>"); the data group's collectives ("collectives") and the
    hops of a mesh across processes ("hop:<kind>", parallel/hop.py)."""
    from lstm_rnn_tpu_torch.ops import gemm, lstm_cell, lstm_tp, softmax_ce
    from lstm_rnn_tpu_torch.parallel import hop
    found = {f"gemm:{u}": c for u, c in gemm.LAUNCHES.items()}
    for module in (lstm_cell, lstm_tp, softmax_ce):
        found.update((name, obj) for name, obj in vars(module).items()
                     if isinstance(getattr(obj, "launches", None), int))
    found["collectives"] = _Collectives()
    found.update((f"hop:{k}", _Hops(k)) for k in hop.COUNTS)
    return found


@contextlib.contextmanager
def _mesh_streams(main: torch.cuda.Stream, others: Sequence[torch.device]):
    """Run the body with each device of `others` on a side stream of its
    own, forked from `main` (so that under a capture it joins the
    capture) and joined back into `main` at the end; the body's current
    device is main's."""
    sides = [torch.cuda.Stream(d) for d in others]
    with contextlib.ExitStack() as stack:
        for side in sides:
            side.wait_stream(main)
            stack.enter_context(torch.cuda.stream(side))
        with torch.cuda.device(main.device):
            yield
    for side in sides:
        main.wait_stream(side)


class GraphStats:
    """What a Trainer's step graphs did, over all of them: warm-ups,
    captures, replays, eager steps (declined captures), the largest
    warm-up peak, and for each capture (in order) its key, seconds, pool
    bytes, replays and the launches it recorded (counter name -> n)."""

    def __init__(self):
        self.warmups = 0
        self.captures = 0
        self.replays = 0
        self.eager = 0
        # device -> the largest warm-up's peak there
        self.peak_need: Dict[torch.device, int] = {}
        self.log: List[dict] = []

    def executed(self, name: str, counted: int) -> int:
        """The launches of counter `name` that ran, given its count over
        the same run: each capture's recorded launches, which the count
        holds once, counted once for each of its replays instead."""
        return counted + sum(c["launches"].get(name, 0) * (c["replays"] - 1)
                             for c in self.log)

    def as_dict(self) -> dict:
        return {"warmups": self.warmups, "captures": self.captures,
                "replays": self.replays, "eager": self.eager,
                "capture_seconds": [c["seconds"] for c in self.log],
                "pool_bytes": [c["pool_bytes"] for c in self.log],
                "launches": [c["launches"] for c in self.log]}


class StepGraph:
    """One fraction shape's step (train or eval) as a CUDA graph; see the
    module docstring. fn(inputs, targets, pattypes) -> (err, correct) is
    the eager step, which may update tensors in place (the parameters and
    the velocity) but must rebind nothing the graph reads. `devices`: the
    GPUs the step runs on besides its inputs' (a mesh's; repeats and the
    inputs' own GPU among them are dropped)."""

    def __init__(self, key, fn: Callable, like: Tuple[torch.Tensor, ...],
                 stats: GraphStats,
                 note: Optional[Callable[[str], None]] = None,
                 devices: Sequence[torch.device] = ()):
        self.key = key
        self.fn = fn
        self.device = like[0].device
        # "cuda" names the current GPU
        indexed = (torch.device(d.type, torch.cuda.current_device())
                   if d.index is None else d for d in map(torch.device,
                                                          devices))
        self.others = [d for d in dict.fromkeys(indexed)
                       if d != self.device]
        self.devices = [self.device] + self.others
        self.static = tuple(torch.empty_like(a) for a in like)
        self.stats = stats
        self.note = note or (lambda msg: None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.pools: Dict[torch.device, tuple] = {}  # the other GPUs' pools
        self.out: Tuple[torch.Tensor, ...] = ()
        self.warm = False
        self.eager = False
        # device -> bytes the warm-up allocated above its start there
        self.needs: Dict[torch.device, int] = {}
        self.pool_bytes = 0
        self.record: Optional[dict] = None  # this graph's entry in stats.log

    def __call__(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.eager:
            self.stats.eager += 1
            return self.fn(*batch)
        for s, a in zip(self.static, batch):
            s.copy_(a)
        if not self.warm:
            return self._warm_up()
        if self.graph is None:
            if not self._fits():
                self.eager = True
                self.stats.eager += 1
                return self.fn(*self.static)
            self._capture()
        main = torch.cuda.current_stream(self.device)
        for d in self.others:
            main.wait_stream(torch.cuda.current_stream(d))
        self.graph.replay()
        for d in self.others:
            torch.cuda.current_stream(d).wait_stream(main)
        self.stats.replays += 1
        self.record["replays"] += 1
        return tuple(o.clone() for o in self.out)

    def _warm_up(self):
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        for d in self.others:
            side.wait_stream(torch.cuda.current_stream(d))
        start = {}
        for d in self.devices:
            start[d] = torch.cuda.memory_allocated(d)
            torch.cuda.reset_peak_memory_stats(d)
        with torch.cuda.stream(side), _mesh_streams(side, self.others):
            out = self.fn(*self.static)
        main.wait_stream(side)
        for d in self.others:
            torch.cuda.current_stream(d).wait_stream(side)
        peak = self.stats.peak_need
        for d in self.devices:
            self.needs[d] = torch.cuda.max_memory_allocated(d) - start[d]
            peak[d] = max(peak.get(d, 0), self.needs[d])
        self.warm = True
        self.stats.warmups += 1
        return tuple(o.clone() for o in out)

    def _fits(self) -> bool:
        """Whether the capture's pool fits with room left for the largest
        eager step seen (a warm-up, or a pass that does not fuse), on
        every GPU of the step: the two peaks against the GPU's free bytes
        and the caching allocator's unused ones."""
        for d in self.devices:
            free = (torch.cuda.mem_get_info(d)[0]
                    + torch.cuda.memory_reserved(d)
                    - torch.cuda.memory_allocated(d))
            need = self.needs.get(d, 0)
            keep = self.stats.peak_need.get(d, 0)
            if need + keep > free:
                self.note(f"the step of shape {self.key} needs ~"
                          f"{need / 2**20:.0f} MiB for its graph on {d} "
                          f"and {keep / 2**20:.0f} MiB stay free for eager "
                          f"steps but {free / 2**20:.0f} MiB are free: it "
                          "runs eagerly")
                return False
        return True

    def _capture(self) -> None:
        counters = launch_counters()
        before = {name: c.launches for name, c in counters.items()}
        # torch.cuda.graph empties the cache on entry too: empty it first,
        # so that the reserved bytes' growth is the pools'
        for d in self.devices:
            torch.cuda.synchronize(d)
        torch.cuda.empty_cache()
        reserved = {d: torch.cuda.memory_reserved(d) for d in self.devices}
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(self.device)
        # every allocation on another GPU of the step (any stream, any
        # thread: autograd runs a device's backward on a thread of its
        # own) goes to that GPU's pool while the capture lasts
        self.pools = {d: torch.cuda.graph_pool_handle() for d in self.others}
        for d, pool in self.pools.items():
            torch._C._cuda_beginAllocateToPool(d.index, pool)
        try:
            with torch.cuda.device(self.device), \
                    torch.cuda.graph(graph, stream=stream), \
                    _mesh_streams(stream, self.others):
                out = self.fn(*self.static)
        finally:
            for d, pool in self.pools.items():
                torch._C._cuda_endAllocateToPool(d.index, pool)
        seconds = time.perf_counter() - t0
        self.graph, self.out = graph, tuple(out)
        self.pool_bytes = sum(torch.cuda.memory_reserved(d) - reserved[d]
                              for d in self.devices)
        self.record = {
            "key": self.key, "seconds": seconds,
            "pool_bytes": self.pool_bytes, "replays": 0,
            "launches": {name: c.launches - before[name]
                         for name, c in counters.items()
                         if c.launches != before[name]}}
        self.stats.captures += 1
        self.stats.log.append(self.record)

    def release(self) -> None:
        """Free the graph, then its pools on the other GPUs."""
        self.graph = None
        self.out = ()
        for d, pool in self.pools.items():
            torch._C._cuda_releasePool(d.index, pool)
        self.pools = {}
