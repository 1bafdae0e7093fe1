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

A capture or replay that fails raises; nothing falls back to the eager
step on the card. On the CPU there are no graphs: the Trainer runs the
same steps eagerly (trainer.py `_fused_step`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


def launch_counters() -> Dict[str, object]:
    """Every launch counter of the port's kernels, found in ops/: each
    object of ops/lstm_cell.py and ops/softmax_ce.py with an integer
    `.launches` (the wrappers, the 3x counts) and the GEMM engine's
    per-product counters (ops/gemm.py `LAUNCHES`, as "gemm:<use>")."""
    from lstm_rnn_tpu_torch.ops import gemm, lstm_cell, softmax_ce
    found = {f"gemm:{u}": c for u, c in gemm.LAUNCHES.items()}
    for module in (lstm_cell, softmax_ce):
        found.update((name, obj) for name, obj in vars(module).items()
                     if isinstance(getattr(obj, "launches", None), int))
    return found


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
        self.peak_need = 0
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
    the velocity) but must rebind nothing the graph reads."""

    def __init__(self, key, fn: Callable, like: Tuple[torch.Tensor, ...],
                 stats: GraphStats,
                 note: Optional[Callable[[str], None]] = None):
        self.key = key
        self.fn = fn
        self.device = like[0].device
        self.static = tuple(torch.empty_like(a) for a in like)
        self.stats = stats
        self.note = note or (lambda msg: None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Tuple[torch.Tensor, ...] = ()
        self.warm = False
        self.eager = False
        self.need = 0  # bytes the warm-up allocated above its start
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
        self.graph.replay()
        self.stats.replays += 1
        self.record["replays"] += 1
        return tuple(o.clone() for o in self.out)

    def _warm_up(self):
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.cuda.stream(side):
            out = self.fn(*self.static)
        main.wait_stream(side)
        self.need = torch.cuda.max_memory_allocated(dev) - start
        self.warm = True
        self.stats.warmups += 1
        self.stats.peak_need = max(self.stats.peak_need, self.need)
        return tuple(o.clone() for o in out)

    def _fits(self) -> bool:
        """Whether the capture's pool fits with room left for the largest
        eager step seen (a warm-up, or a pass that does not fuse): the
        two peaks against the card's free bytes and the caching
        allocator's unused ones."""
        dev = self.device
        free = (torch.cuda.mem_get_info(dev)[0]
                + torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
        if self.need + self.stats.peak_need <= free:
            return True
        self.note(f"the step of shape {self.key} needs ~"
                  f"{self.need / 2**20:.0f} MiB for its graph and "
                  f"{self.stats.peak_need / 2**20:.0f} MiB stay free for "
                  f"eager steps but {free / 2**20:.0f} MiB are free: it "
                  "runs eagerly")
        return False

    def _capture(self) -> None:
        dev = self.device
        counters = launch_counters()
        before = {name: c.launches for name, c in counters.items()}
        # torch.cuda.graph empties the cache on entry too: empty it first,
        # so that the reserved bytes' growth is the pool's
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.fn(*self.static)
        seconds = time.perf_counter() - t0
        self.graph, self.out = graph, tuple(out)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.record = {
            "key": self.key, "seconds": seconds,
            "pool_bytes": self.pool_bytes, "replays": 0,
            "launches": {name: c.launches - before[name]
                         for name, c in counters.items()
                         if c.launches != before[name]}}
        self.stats.captures += 1
        self.stats.log.append(self.record)
