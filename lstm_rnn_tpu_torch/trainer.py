"""Training loop: momentum SGD, the epoch driver, best-weight tracking.

Counterpart of lstm_rnn_tpu/trainer.py, reproducing
`currennt_lib/src/optimizers/`:

- SteepestDescentOptimizer (SteepestDescentOptimizer.cu:39-94):
  v <- momentum * v - lr * grad, then w <- w + v, with the per-layer
  `learningRate` JSON override (>= 0 replaces the global lr);
- the epoch driver (Optimizer.cu:284-324): a training pass with updates,
  validation every `validate_every` epochs (tracking the lowest error and
  snapshotting the best weights), a test pass every `test_every` epochs,
  and a stop after `max_epochs_no_best` epochs without a new best or at
  `max_epochs`, restoring the best weights; with no validation set the
  best weights are those of every epoch (Optimizer.cu:306-309);
- _processDataSet (Optimizer.cu:38-104): per fraction the forward, the
  error sum and the classification count; stochastic (hybrid online/batch)
  mode updates after every fraction, batch mode accumulates the gradients
  of the whole pass and updates once; epoch error = sum of fraction errors
  / sequences, classification error = 1 - correct / timesteps.

One fraction's step is the network's forward, the loss, autograd's
backward and the update, in place on the parameter tensors. With the
kernel backend ("auto"/"pallas") on a softmax -> multiclass net the loss
is the fused tail (Network.loss_and_count_fused): per training fraction
the LSTM layers run the training forward and the BPTT kernel and the tail
its forward and backward kernels; validation and test passes run without
gradients, through the inference forward and the tail's forward only.
With `net.remat_blocks` (--remat_blocks K) the fused tail stays on, as
the JAX Trainer's does on the TPU: per training fraction each LSTM layer
runs as K checkpointed time blocks per direction on the carry kernels (the
forward with residuals twice, once more in the recompute, and the carry
BPTT) and the tail is the plain pair (K5); validation and test passes are
unchanged but for the tail, K5's forward. The metrics stay on the device
until the end of a pass.

With `seq_mesh` (sequence parallelism, parallel/sequence.py) each
fraction's time axis is cut into blocks, one per device of the mesh: the
loss is `loss_and_count_seq` (the unfused tail: `net.loss_fn` and
`net.correct_count` per block), its LSTM blocks run the carry kernels
(K6b under autograd, K6f in the validation and test passes; remat_blocks
is ignored, as in the JAX package), and the
parameters, their gradients and the SGD update stay on the mesh's first
device.

With `data_group` (data parallelism, parallel/data.py: one process per
device, launched by parallel/launch.py) every rank holds the same
parameters and velocity and sees the same fractions and noise draws; each
fraction's batch is padded to a multiple of the world size with inert rows
and the rank runs its contiguous block of it through the route above. The
gradients are summed over the ranks before each update (stochastic mode:
once per fraction; batch mode: once per pass, on the accumulated
gradients), in one collective per dtype, and each rank then applies the
same update; the error sums and correct counts of a pass are summed over
the ranks once, at its end. With both (DP x SP) the rank's block goes
through `loss_and_count_seq` on the rank's seq mesh, whose first device
is the group's: the blocks' gradients reach the leaves there through
autograd, on the mesh devices' streams, so the update's stream waits for
every device of the mesh before the all-reduce packs them.

With `pipe_mesh` (pipeline parallelism, parallel/pipeline.py) the loss is
`loss_and_count_pipelined` over `pipeline_microbatches` microbatches (0:
the stage count), its last stage ending with the fused tail where the net
takes it; with `model_mesh` (tensor parallelism, parallel/tensor.py) the
net's LSTM layers shard their cells over the mesh, and the fused tail
follows on the mesh's first device. Either mesh composes with a data
group as the seq mesh does: its first device is the group's, where the
parameters, the gradients and the update stay, and the update's stream
waits for every device of the mesh before the all-reduce.

A seq or pipe mesh that spans processes (parallel/mesh.py `SpanMesh`, the
JAX package's 1-D mesh over every host's devices) comes with the data
group that holds it (`DataGroup.span`): every process takes the whole
fraction, runs its own blocks or stages (the carries and stage messages
cross over parallel/hop.py), and the group's sums add up the processes'
shares of the gradients, the errors and the counts, so that every process
applies the same update. A process's first owned device is its device.

The optimizer state for autosaves (Optimizer.cu:326-341,
SteepestDescentOptimizer.cu:118-123) goes out through `export_state` and
comes back through `import_state`, in the reference's layer-array layout.
A restored run also replays the training set's per-epoch shuffles and
input-noise draws of the epochs already done, and discards the weight-noise
draws of those epochs, so that it sees the fraction order and the noise the
uninterrupted run would have seen (the JAX package starts both streams
afresh at the seed).

Weight noise (`weight_noise_sigma` > 0, Optimizer.cu:58-84): once per
training fraction, in stochastic and batch mode alike, N(0, sigma) is drawn
for every parameter from the host stream `RandomState(seed & 0x7FFFFFFF)`,
in float64 cast to float32, leaf by leaf in the JAX package's tree order
(sorted layer names, then sorted keys); the gradient is taken at params +
noise (fresh leaves) and the update goes to the clean params. Validation
and test passes draw nothing. The draw stays on the host, as in the JAX
package, so that the stream is the same; its copy to the card does not
synchronise. Input noise is the DataSet's (data/dataset.py).

`float64` parameters (a Network with compute_dtype "float64", the scan
backend, on the CPU only) train the scan route in float64: the port's
counterpart of the JAX package's x64 epoch against the float64 oracle.

The data feed (lstm_rnn_tpu/trainer.py:91-129, :650-691, :741-757):
- a fraction reaches the device through pinned host memory (`_Staging`)
  with a copy that does not synchronise, so the host queues the next
  fraction's work while the card runs this one's;
- `device_cache` keeps fractions whose contents are the same every epoch
  (`Fraction.key`) on the device after their first copy, up to
  `device_cache_bytes` (default 40% of the card's memory), evicting
  entries unused for two epochs or more, not the least recently used:
  a cyclic epoch over a corpus above the budget keeps its admitted prefix
  instead of missing every time. Off unless asked for, as the JAX
  Trainer's is off a TPU. With the cache on, fractions come as
  LazyFraction handles, so a hit assembles nothing, and a miss that the
  DataSet assembles natively is assembled straight into the staging
  buffer (`_native_layout`: float32 inputs, no data group splitting the
  fraction), so its bytes are written once on the host; the device
  tensors are the copy's, bit for bit. Under a data group
  the rank's block is cached, under a seq mesh the fraction on the mesh's
  first device. `h2d_bytes` counts the bytes copied from the host, one
  integer a pass.

`fuse_fractions` K > 1 (lstm_rnn_tpu/trainer.py:1022-1108, :772-955): the
JAX Trainer's fused passes, with its gate. Training passes in stochastic
mode without weight noise, and every evaluation pass, step their
fractions through CUDA graphs (graphs.py `StepGraph`): one graph per
fraction shape and mode, captured from the eager step on the shape's
second fraction (its first is the warm-up) and replayed for the rest, in
the pass's order. On the TPU a group of K same-shape fractions was one
jitted fori_loop; here it is K replays, so nothing is stacked for a group
and the JAX package's group byte cap (`MAX_GROUP_STACK_BYTES`, a guard of
the TPU runtime's per-program limit) has no counterpart. Batch-mode and
weight-noise passes step one fraction at a time.
- The stacked epoch (`_try_stacked_epoch`): with the device cache on, a
  pass of cacheable fractions, no more than K of them and no more than
  `STACKED_MAX_SHAPES` shapes, stays on the device, held by the pass's
  entry in place of the fractions' cache entries (the JAX Trainer's
  lookups: misses when it is built, hits when a pass runs from it); each
  step copies its fraction into the graph's static buffers, as a cache
  hit does. The JAX Trainer's per-shape stacks at power-of-two widths
  fed a whole-epoch program; a graph replays one fraction a step, so
  they have no counterpart here. Where a gate fails the JAX Trainer's
  line names it, once a reason ("Epoch-resident fast path declined:
  ..."), and the pass takes the grouped route. Its background compile
  has no counterpart (the warm-up step takes its place), nor has its
  multi-process stack.
- The step graphs' pools count against the device cache's budget
  (`_cache_room`), so that the two together stay within it.
- A graph holds the addresses of the parameters, the velocity, its static
  buffers, and the layers' learning rates and the momentum: the graphs
  are dropped where any of them is rebound (`import_state`, the swap to
  the best weights at the end, and any other change `_binding` sees
  before a step).
- Under a data group (one device a rank) a graph holds the training
  step's packed all-reduce, on NCCL; the stacked epoch holds the rank's
  block of each fraction, and its estimate counts the rank's padded rows
  (the JAX one the global arrays, so the GiB figures of its decline line
  differ by design). On a one-process seq or pipe mesh (alone, or a DP x
  SP or DP x PP rank's) a graph spans every GPU of the mesh
  (`mesh_devices`); on a mesh that names one GPU several times it is
  that GPU's graph. Evaluation graphs hold no collective: a pass sums
  its metrics over the ranks once, at its end, eagerly.
- On a model mesh (tensor parallelism, alone or a DP x TP rank's) a graph
  holds the TP layers' kernels K8f and K8b (ops/lstm_tp.py: one launch a
  layer and GPU, whose flags survive replays) and spans the mesh's GPUs
  as above. On a seq or pipe mesh that spans processes (`span`) it holds
  the hops of parallel/hop.py over NCCL: the warm-up step's eager hops
  make NCCL's point-to-point communicators before any capture, the hops'
  chain fixes their order at capture, and every process issues the same
  messages in the same order whether it replays a graph or steps
  eagerly. Scope: where a hop goes over gloo with CUDA tensors (two
  processes on one card, each message staged through host memory, which
  no capture takes) the passes step one fraction at a time (the same
  values), and the Trainer says so once. On the CPU there is no graph:
  the fused passes run the same steps eagerly, in the same order and
  with the same bookkeeping, so that they equal the unfused run bit for
  bit.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from lstm_rnn_tpu_torch import io_currennt as ioc
from lstm_rnn_tpu_torch.data.dataset import (DataSet, Fraction,
                                             LazyFraction, discard_normals)
from lstm_rnn_tpu_torch.graphs import GraphStats, StepGraph
from lstm_rnn_tpu_torch.network import (Network, params_from_numpy,
                                        params_to_numpy)
from lstm_rnn_tpu_torch.parallel import hop
from lstm_rnn_tpu_torch.parallel.data import all_reduce_sum
from lstm_rnn_tpu_torch.parallel.mesh import SpanMesh
from lstm_rnn_tpu_torch.parallel.pipeline import (loss_and_count_pipelined,
                                                  stage_ranges)
from lstm_rnn_tpu_torch.parallel.sequence import loss_and_count_seq
from lstm_rnn_tpu_torch.utils.device import select_device


def _clone(tree):
    return {n: {k: v.detach().clone() for k, v in layer.items()}
            for n, layer in tree.items()}


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _torch_dtype(dt) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


class _Staging:
    """Host buffers of the copies to the device. On a GPU: pinned, reused
    round robin, and written again only once the copy that last read one
    has completed (its event), so the host stays up to SLOTS copies ahead
    of the card without a synchronisation and never rewrites bytes in
    flight. On the CPU a fresh tensor each time, which is the device's
    (nothing is copied)."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: List[Optional[torch.Tensor]] = [None] * self.SLOTS
        self._events: List[Any] = [None] * self.SLOTS
        self._next = 0
        self.allocations = 0  # pinned buffers allocated

    def to_device(self, nbytes: int, fill) -> torch.Tensor:
        """A uint8 device tensor of nbytes whose bytes fill(host numpy
        uint8 array) wrote."""
        if self.device.type != "cuda":
            host = torch.empty(nbytes, dtype=torch.uint8)
            fill(host.numpy())
            return host
        i = self._next
        self._next = (i + 1) % self.SLOTS
        if self._events[i] is not None:
            self._events[i].synchronize()
        if self._bufs[i] is None or self._bufs[i].numel() < nbytes:
            self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8,
                                        pin_memory=True)
            self.allocations += 1
        host = self._bufs[i][:nbytes]
        fill(host.numpy())
        dev = host.to(self.device, non_blocking=True)
        self._events[i] = torch.cuda.Event()
        self._events[i].record(torch.cuda.current_stream(self.device))
        return dev


class Trainer:
    def __init__(self, net: Network, train_set: DataSet,
                 validation_set: Optional[DataSet] = None,
                 test_set: Optional[DataSet] = None, *,
                 learning_rate: float = 1e-5, momentum: float = 0.9,
                 max_epochs: int = -1, max_epochs_no_best: int = 20,
                 validate_every: int = 1, test_every: int = 1,
                 hybrid_online_batch: bool = False,
                 weight_noise_sigma: float = 0.0, seed: int = 1,
                 device=None, seq_mesh=None, data_group=None,
                 pipe_mesh=None, model_mesh=None,
                 pipeline_microbatches: int = 0,
                 fuse_fractions: int = 1,
                 device_cache: Optional[bool] = None,
                 device_cache_bytes: Optional[int] = None):
        self.net = net
        self.train_set = train_set
        self.validation_set = validation_set
        self.test_set = test_set
        self.momentum = momentum
        self.max_epochs = max_epochs
        self.max_epochs_no_best = max_epochs_no_best
        self.validate_every = validate_every
        self.test_every = test_every
        self.hybrid_online_batch = hybrid_online_batch
        self.weight_noise_sigma = weight_noise_sigma
        # the JAX Trainer's weight-noise stream (its trainer.py:89)
        self._noise_rng = np.random.RandomState(seed & 0x7FFFFFFF)
        # the card unless the caller names a device (raises without a GPU);
        # under a mesh, the mesh's first device
        self.seq_mesh = seq_mesh
        self.pipe_mesh = pipe_mesh
        self.model_mesh = model_mesh
        self.pipeline_microbatches = pipeline_microbatches
        self.data_group = data_group
        # a mesh that spans processes lists this process's devices only
        meshes = [(kind, m.local if isinstance(m, SpanMesh)
                   else [torch.device(d) for d in m]) for kind, m in (
            ("seq", seq_mesh), ("pipe", pipe_mesh), ("model", model_mesh))
            if m is not None]
        self.span = next((m for m in (seq_mesh, pipe_mesh)
                          if isinstance(m, SpanMesh)), None)
        if self.span is not None and (
                data_group is None or data_group.span is not self.span):
            raise ValueError("a mesh that spans processes trains with the "
                             "data group that holds it (DataGroup.span)")
        if len(meshes) > 1:
            raise ValueError("the Trainer takes one of seq_mesh, pipe_mesh "
                             "and model_mesh")
        # every device of the rank's mesh (the update waits for them all)
        self.mesh_devices = meshes[0][1] if meshes else []
        if data_group is not None:
            if meshes and meshes[0][1][0] != data_group.device:
                raise ValueError(f"the {meshes[0][0]} mesh's first device "
                                 f"{meshes[0][1][0]} is not the data "
                                 f"group's device {data_group.device}")
            if device is not None and (torch.device(device)
                                       != data_group.device):
                raise ValueError(f"device {device} is not the data group's "
                                 f"device {data_group.device}")
            device = data_group.device
        if meshes:
            kind, mesh = meshes[0]
            if device is not None and torch.device(device) != mesh[0]:
                raise ValueError(f"device {device} is not the {kind} mesh's "
                                 f"first device {mesh[0]}")
            device = mesh[0]
        if pipe_mesh is not None:
            stage_ranges(len(net.specs) - 2, len(pipe_mesh))
        # tensor parallelism: the net's LSTM layers shard over the mesh
        net.model_mesh = self.mesh_devices if model_mesh is not None \
            else None
        net.validate_tp()
        self.device = select_device() if device is None \
            else torch.device(device)
        # float64 parameters train the scan route on the CPU only
        self.dtype = net.param_dtype
        if self.dtype == torch.float64 and self.device.type != "cpu":
            raise ValueError("float64 parameters train on the CPU only")
        # per-layer learning rates (>= 0 overrides the global one,
        # SteepestDescentOptimizer.cu:78-80)
        self.layer_lr: Dict[str, float] = {
            s.name: (s.learning_rate if s.learning_rate >= 0
                     else learning_rate)
            for s in net.trainable_specs()}
        # the fused tail is off under a seq mesh, as in the JAX Trainer;
        # under a pipe mesh the last stage takes it, under a model mesh it
        # follows the sharded LSTM layers on the mesh's first device
        self.fused_tail = seq_mesh is None and net.takes_fused_tail()
        self.params = params_from_numpy(net.params, self.device, self.dtype)
        for layer in self.params.values():
            for v in layer.values():
                v.requires_grad_(True)
        self.velocity = {n: {k: torch.zeros_like(v) for k, v in l.items()}
                         for n, l in self.params.items()}
        self.best_params = _clone(self.params)

        self._staging = _Staging(self.device)
        self.device_cache = bool(device_cache)
        # key -> [(inputs, targets, pattypes), bytes, epoch last used]
        self._dev_cache: Dict[Any, list] = {}
        self._dev_cache_budget = (self._auto_cache_bytes(self.device)
                                  if device_cache_bytes is None
                                  else int(device_cache_bytes))
        self._dev_cache_bytes = 0
        # this epoch's lookups (the CLI prints them in the epoch row)
        self.cache_hits = 0
        self.cache_misses = 0
        # bytes copied from the host to the device, one entry a pass
        self.h2d_bytes: List[int] = []
        self._pass_bytes = 0

        # fused passes: step graphs by (mode, shapes, dtypes), the
        # addresses they were captured against, the per-DataSet stacked
        # epochs, and the reasons already printed
        self.fuse_fractions = max(1, int(fuse_fractions))
        self._graphs: Dict[Any, StepGraph] = {}
        self._graph_binding = None
        self.graph_stats = GraphStats()
        self._stacked: Dict[Any, dict] = {}
        self._stacked_decline_reasons: set = set()
        self._notes: set = set()

        # optimizer state (Optimizer.cu constructor)
        self.finished = False
        self.cur_epoch = 0
        self.epochs_since_lowest = 0
        self.lowest_validation_error = float("inf")
        self.cur_training_error = float("inf")
        self.cur_validation_error = float("inf")
        self.cur_test_error = float("inf")
        self.cur_training_class_error = 0.0
        self.cur_validation_class_error = 0.0
        self.cur_test_class_error = 0.0

    # ------------------------------------------------------------------ steps
    def loss_and_metrics(self, params, inputs, targets, pattypes):
        """(error sum, correct count) of one fraction, as device scalars."""
        if self.seq_mesh is not None:
            return loss_and_count_seq(self.net, params, inputs, targets,
                                      pattypes, self.seq_mesh)
        if self.pipe_mesh is not None:
            return loss_and_count_pipelined(
                self.net, params, inputs, targets, pattypes,
                self.span if self.span is not None else self.mesh_devices,
                self.pipeline_microbatches)
        if self.fused_tail:
            return self.net.loss_and_count_fused(params, inputs, targets,
                                                 pattypes)
        y = self.net.apply(params, inputs, pattypes)
        return (self.net.loss_fn(y, targets, pattypes),
                self.net.correct_count(y, targets, pattypes))

    def _leaves(self, tree):
        return [tree[n][k] for n in sorted(tree) for k in sorted(tree[n])]

    def _draw_noise(self):
        """One weight-noise draw: N(0, sigma) for every parameter from the
        host stream, float64 cast to float32, leaf by leaf in the JAX tree
        order (trainer.py:569-580 of the JAX package), copied to the
        parameters' device without a synchronisation."""
        sig = self.weight_noise_sigma
        return {n: {k: torch.from_numpy(self._noise_rng.normal(
                    0.0, sig, tuple(self.params[n][k].shape)).astype(
                        np.float32)).to(self.device, non_blocking=True)
                    for k in sorted(self.params[n])}
                for n in sorted(self.params)}

    def _point(self):
        """Where a training fraction's gradient is taken: the parameters,
        or with weight noise fresh leaves at params + one draw (the update
        still goes to the clean parameters)."""
        if self.weight_noise_sigma <= 0:
            return self.params
        noise = self._draw_noise()
        return {n: {k: (v.detach() + noise[n][k]).requires_grad_(True)
                    for k, v in layer.items()}
                for n, layer in self.params.items()}

    def grad_fraction(self, inputs, targets, pattypes, at=None):
        """(error, correct, grads) at `at` (default: the current
        parameters); grads in the parameter tree's layout."""
        at = self.params if at is None else at
        err, correct = self.loss_and_metrics(at, inputs, targets, pattypes)
        leaves = self._leaves(at)
        # on a pipe mesh over processes a process's loss reaches only its
        # stages' layers: the others' gradients are its zero share
        grads = torch.autograd.grad(err, leaves,
                                    allow_unused=self.span is not None)
        it = (torch.zeros_like(v) if g is None else g
              for g, v in zip(grads, leaves))
        tree = {n: {k: next(it) for k in sorted(self.params[n])}
                for n in sorted(self.params)}
        return err.detach(), correct, tree

    def _sum_over_ranks(self, tensors) -> None:
        """Sum tensors over the data group's ranks, in place (a no-op
        without a group). Under DP x SP, DP x PP and DP x TP the tensors
        were summed on the mesh's first device from work on its other
        GPUs: this device's stream first waits for every one of theirs."""
        if self.data_group is None:
            return
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            for dev in set(self.mesh_devices) - {self.device}:
                stream.wait_stream(torch.cuda.current_stream(dev))
        all_reduce_sum(tensors, self.data_group.group)

    @torch.no_grad()
    def sgd_update(self, grads) -> None:
        """v <- momentum * v - lr * g, then w <- w + v, in that order
        (trainer.py:486-495 of the JAX package), per layer's lr. Under a
        data group the gradients are first summed over the ranks (the JAX
        package's psum), so every rank applies the same update."""
        self._sum_over_ranks(self._leaves(grads))
        for name, layer in grads.items():
            lr = self.layer_lr[name]
            for k, g in layer.items():
                v = self.velocity[name][k]
                v.copy_(self.momentum * v - lr * g)
                self.params[name][k].add_(v)

    def train_step(self, inputs, targets, pattypes):
        """Stochastic mode: gradients at the current weights (plus a draw
        of weight noise), then the update. Returns (error, correct) of the
        fraction before it."""
        err, correct, grads = self.grad_fraction(inputs, targets, pattypes,
                                                 self._point())
        self.sgd_update(grads)
        return err, correct

    def accum_step(self, grad_acc, inputs, targets, pattypes):
        """Batch mode: add the fraction's gradients to grad_acc (None on
        the first fraction), no update; with weight noise, at a draw of
        it. Returns (grad_acc, error, correct)."""
        err, correct, grads = self.grad_fraction(inputs, targets, pattypes,
                                                 self._point())
        if grad_acc is None:
            return grads, err, correct
        for name, layer in grads.items():
            for k, g in layer.items():
                grad_acc[name][k].add_(g)
        return grad_acc, err, correct

    @torch.no_grad()
    def eval_step(self, inputs, targets, pattypes):
        return self.loss_and_metrics(self.params, inputs, targets, pattypes)

    # ------------------------------------------------------------------ epoch
    @staticmethod
    def _auto_cache_bytes(device: torch.device, fraction: float = 0.4,
                          fallback: int = 6 * 1024**3) -> int:
        """The device cache's budget: 40% of the card's memory (the rest
        for the parameters, the velocity and a step's activations), 6 GiB
        off CUDA."""
        if device.type != "cuda":
            return fallback
        return int(torch.cuda.mem_get_info(device)[1] * fraction)

    def _to_device(self, host: tuple) -> tuple:
        """A fraction's (inputs, targets, pattypes) host arrays on the
        device in one copy from a staging buffer, the inputs in the
        parameters' dtype; the three tensors are views of the copy."""
        kinds = [(np.dtype(_NP_DTYPE[self.dtype]), host[0].shape)] + [
            (host[j].dtype, host[j].shape) for j in (1, 2)]

        def write(views):
            for view, h in zip(views, host):
                view[...] = h

        return self._stage(kinds, write)

    def _stage(self, kinds, write) -> tuple:
        """Three device tensors of kinds' (dtype, shape) in one copy from a
        staging buffer: write(views) fills the buffer's three C-contiguous
        numpy views, each 64-byte aligned."""
        sizes = [int(np.prod(shape)) * dt.itemsize for dt, shape in kinds]
        offsets, total = [], 0
        for size in sizes:
            total = -(-total // 64) * 64
            offsets.append(total)
            total += size

        def fill(buf):
            write([buf[off:off + size].view(dt).reshape(shape)
                   for (dt, shape), off, size in zip(kinds, offsets,
                                                     sizes)])

        dev = self._staging.to_device(total, fill)
        self._pass_bytes += sum(sizes)
        return tuple(dev[off:off + size].view(_torch_dtype(dt)).view(shape)
                     for (dt, shape), off, size in zip(kinds, offsets,
                                                       sizes))

    def _cache_room(self) -> int:
        """The bytes the cache may hold: its budget less the step graphs'
        pools, so that the two together stay within the budget."""
        return self._dev_cache_budget - sum(g.pool_bytes
                                            for g in self._graphs.values())

    def _cache_evict_stale(self, need: int) -> None:
        """Evict entries unused for two epochs or more until `need` bytes
        fit (or none is left stale); entries used this epoch or the last
        stay."""
        room = self._cache_room()
        if self._dev_cache_bytes + need <= room:
            return
        horizon = self.cur_epoch - 1
        for key in [k for k, e in self._dev_cache.items() if e[2] < horizon]:
            self._dev_cache_bytes -= self._dev_cache.pop(key)[1]
            if self._dev_cache_bytes + need <= room:
                return

    def _cache_put(self, key, batch) -> None:
        """Admit a fraction's device tensors under key if the budget has
        room after evicting stale entries."""
        nbytes = sum(a.numel() * a.element_size() for a in batch)
        self._cache_evict_stale(nbytes)
        if self._dev_cache_bytes + nbytes <= self._cache_room():
            self._dev_cache[key] = [batch, nbytes, self.cur_epoch]
            self._dev_cache_bytes += nbytes

    def _native_layout(self, frac):
        """The staging layout of a LazyFraction not yet assembled that can
        be assembled natively straight into the staging buffer (no copy
        on the host): no data group splits the block and the inputs are
        staged as float32. None: copy the assembled arrays."""
        if (not isinstance(frac, LazyFraction)
                or _NP_DTYPE[self.dtype] is not np.float32
                or (self.data_group is not None
                    and self.data_group.span is None)):
            return None
        return frac.native_layout()

    def _device_batch(self, frac: Fraction) -> tuple:
        """The fraction's (inputs, targets, pattypes) on the device (under a
        data group this rank's block, after padding B to a multiple of the
        world size): a cached fraction where it lies, else copied (and
        cached after the copy when keyed). A miss on a LazyFraction that
        _native_layout admits is assembled straight into the staging
        buffer, the same bytes the copy moves."""
        key = frac.key if self.device_cache else None
        if key is not None:
            hit = self._dev_cache.get(key)
            if hit is not None:
                hit[2] = self.cur_epoch
                self.cache_hits += 1
                return hit[0]
            self.cache_misses += 1
        layout = self._native_layout(frac)
        if layout is not None:
            batch = self._stage(layout, lambda views: frac.assemble_into(
                *views))
        else:
            batch = self._to_device(self._block(frac))
        if key is not None:
            self._cache_put(key, batch)
        return batch

    # ------------------------------------------------------- fused passes
    # distinct fraction shapes above which the stacked epoch declines: the
    # JAX Trainer's bound, whose decline line is kept word for word (there
    # a compiled whole-epoch program a shape; here a step graph a shape
    # and mode, each with its own pool)
    STACKED_MAX_SHAPES = 8

    def _note(self, msg: str) -> None:
        """Print msg once in the Trainer's life."""
        if msg not in self._notes:
            self._notes.add(msg)
            print(msg, flush=True)

    def _note_stacked_decline(self, reason: str) -> None:
        """Name why the stacked epoch declined, once a reason, in the JAX
        Trainer's words (its trainer.py:759-766)."""
        if reason not in self._stacked_decline_reasons:
            self._stacked_decline_reasons.add(reason)
            print(f"Epoch-resident fast path declined: {reason}", flush=True)

    def _fuse(self, update: bool) -> int:
        """The pass's fuse count: K for stochastic training without weight
        noise and for every evaluation pass (the JAX gate,
        lstm_rnn_tpu/trainer.py:1031-1033), else 1; 1 outside the graphs'
        scope (a mesh across processes whose hops are staged through host
        memory), which the Trainer names once."""
        fuse = (self.fuse_fractions
                if not update or (self.hybrid_online_batch
                                  and self.weight_noise_sigma <= 0) else 1)
        if fuse > 1 and self.span is not None and any(
                hop._staged(g, self.device)
                for g in self.span.groups.values()):
            self._note(f"fuse_fractions={fuse}: no step graph holds a seq "
                       "or pipe mesh that spans processes; every pass "
                       "steps one fraction at a time (the same values)")
            return 1
        return fuse

    def _block(self, frac: Fraction) -> tuple:
        """The fraction's (inputs, targets, pattypes) host arrays, under a
        data group this rank's block (B padded to a multiple of the world
        size)."""
        arrays = (frac.inputs, frac.targets, frac.pattypes)
        if self.data_group is not None:
            arrays = self.data_group.block(*arrays)
        return arrays

    def _block_rows(self, b: int) -> int:
        """The rows of this rank's block of a fraction of b rows."""
        dg = self.data_group
        if dg is None or dg.span is not None:
            return b
        return -(-b // dg.size)

    def _binding(self) -> tuple:
        """What a step graph holds: the parameters' and velocity's
        addresses, the layers' learning rates and the momentum."""
        return (tuple(v.data_ptr() for v in self._leaves(self.params)),
                tuple(v.data_ptr() for v in self._leaves(self.velocity)),
                tuple(sorted(self.layer_lr.items())), self.momentum)

    def drop_graphs(self) -> None:
        """Forget every step graph (and free its pools): the next fraction
        of each shape warms up and captures again."""
        for graph in self._graphs.values():
            graph.release()
        self._graphs.clear()
        self._graph_binding = None

    def _fused_step(self, batch, update: bool):
        """One step of a fused pass: (error, correct) of the fraction. On
        a CUDA device through its shape's step graph, on the CPU the eager
        step."""
        step = self.train_step if update else self.eval_step
        if self.device.type != "cuda":
            return step(*batch)
        binding = self._binding()
        if binding != self._graph_binding:
            self.drop_graphs()
            self._graph_binding = binding
        key = (update,) + tuple((tuple(a.shape), a.dtype) for a in batch)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = StepGraph(
                ("train" if update else "eval", tuple(batch[0].shape)),
                step, batch, self.graph_stats, self._note,
                self.mesh_devices)
        return graph(batch)

    def _frame_bytes(self, w: int) -> int:
        """Device bytes a frame of a fraction takes: the inputs in the
        parameters' dtype, the targets (an int32 class or the dense f32
        row), one pattype byte."""
        tw = (1 if "classification" in self.net.specs[-1].type
              else self.net.target_size)
        return w * _NP_DTYPE[self.dtype]().itemsize + 4 * tw + 1

    def _try_stacked_epoch(self, fracs, update: bool, fuse: int):
        """The stacked epoch (lstm_rnn_tpu/trainer.py:781-955): when a whole
        pass of cacheable fractions fits the cache's room and spans few
        shapes, its fractions stay on the device, held by the pass's entry
        in place of their cache entries, and each step takes its fraction
        from there. On the TPU the entry was one stack a shape for a
        whole-epoch program; a step graph takes one fraction a step, so
        the entry holds the fractions as the cache does. Returns the
        steps' (error, correct) pairs, or None when a gate declines (the
        grouped route then runs), in the JAX Trainer's words."""
        if not fracs:
            return None
        if not self.device_cache:
            return self._note_stacked_decline("device cache is off")
        if len(fracs) > fuse:
            return self._note_stacked_decline(
                f"fuse_fractions={fuse} < {len(fracs)} fractions — raise "
                "--fuse_fractions to cover the whole pass")
        keys = [f.key for f in fracs]
        if any(k is None for k in keys):
            return self._note_stacked_decline(
                "fractions are not epoch-invariant (input noise or "
                "per-epoch sequence shuffling)")
        shapes = {tuple(f.shape) for f in fracs}
        if len(shapes) > self.STACKED_MAX_SHAPES:
            return self._note_stacked_decline(
                f"{len(shapes)} distinct fraction shapes > "
                f"{self.STACKED_MAX_SHAPES} (one whole-epoch compile each) "
                "— use --bucket_lengths single/pow2")
        token = keys[0][0]  # the DataSet's namespace
        entry = self._stacked.get(token)
        if entry is not None and any(k not in entry["rows"] for k in keys):
            # the corpus' membership changed: drop the entry
            self._dev_cache_bytes -= entry["bytes"]
            del self._stacked[token]
            entry = None
        if entry is None:
            # the rank's rows (the JAX estimate counts the global arrays)
            est = sum(t * self._block_rows(b) * self._frame_bytes(w)
                      for t, b, w in (f.shape for f in fracs))
            reclaim = sum(self._dev_cache[k][1] for k in keys
                          if k in self._dev_cache)
            room = self._cache_room()
            if self._dev_cache_bytes - reclaim + est > room:
                free = room - (self._dev_cache_bytes - reclaim)
                return self._note_stacked_decline(
                    f"stacked corpus needs ~{est / 2**30:.2f} GiB but only "
                    f"{max(free, 0) / 2**30:.2f} GiB of device_cache_bytes "
                    f"remain (budget {self._dev_cache_budget / 2**30:.2f} "
                    "GiB)")
            entry = self._stacked[token] = {"rows": {}, "bytes": 0}
            for f, k in zip(fracs, keys):
                # the entry supersedes the fraction's own cache entry
                old = self._dev_cache.pop(k, None)
                if old is not None:
                    self._dev_cache_bytes -= old[1]
                batch = self._to_device(self._block(f))
                nbytes = sum(a.numel() * a.element_size() for a in batch)
                entry["rows"][k] = batch
                entry["bytes"] += nbytes
                self._dev_cache_bytes += nbytes
                self.cache_misses += 1
        else:
            self.cache_hits += len(keys)
        return [self._fused_step(entry["rows"][k], update) for k in keys]

    def _process_dataset(self, ds: DataSet, update: bool):
        """One pass over ds; returns (error sum, correct) device scalars,
        summed over a data group's ranks once, at the end. With the
        device cache on and ds cacheable, the fractions are lazy handles:
        a hit assembles nothing. A fused pass (`_fuse`) first tries the
        stacked epoch, and else steps each fraction through its shape's
        graph, in the pass's order; the sums are the same either way."""
        grad_acc = None
        lazy = (self.device_cache and ds.noise_deviation == 0.0
                and not ds.sequence_shuffling)
        fuse = self._fuse(update)
        self._pass_bytes = 0
        fracs = ds.lazy_fractions() if lazy else ds.fractions()
        steps = None
        if fuse > 1 and lazy:
            fracs = list(fracs)
            steps = self._try_stacked_epoch(fracs, update, fuse)
        if steps is None:
            steps = []
            for frac in fracs:
                batch = self._device_batch(frac)
                if fuse > 1:
                    steps.append(self._fused_step(batch, update))
                elif not update:
                    steps.append(self.eval_step(*batch))
                elif self.hybrid_online_batch:
                    steps.append(self.train_step(*batch))
                else:
                    grad_acc, err, corr = self.accum_step(grad_acc, *batch)
                    steps.append((err, corr))
        errs = [err for err, _ in steps]
        corrs = [corr for _, corr in steps]
        self.h2d_bytes.append(self._pass_bytes)
        if update and not self.hybrid_online_batch and grad_acc is not None:
            self.sgd_update(grad_acc)
        if not errs:
            return None, None
        err = torch.stack([e.detach().to(self.dtype) for e in errs]).sum()
        corr = torch.stack([c.to(torch.int64) for c in corrs]).sum()
        self._sum_over_ranks([err, corr])
        return err, corr

    def device_cache_stats(self) -> Dict[str, int]:
        """This epoch's lookups and the cache's entries and bytes."""
        return {"hits": self.cache_hits, "misses": self.cache_misses,
                "entries": len(self._dev_cache),
                "bytes": self._dev_cache_bytes}

    @staticmethod
    def _fetch_metrics(ds: DataSet, err_dev, corr_dev):
        total_err = float(err_dev) if err_dev is not None else 0.0
        correct = int(corr_dev) if corr_dev is not None else 0
        return (total_err / ds.total_sequences,
                1.0 - correct / ds.total_timesteps)

    def train_epoch(self) -> bool:
        """One epoch (Optimizer::train, Optimizer.cu:284-324); returns True
        when training is finished."""
        if self.finished:
            return True
        self.cur_epoch += 1
        self.cache_hits = 0
        self.cache_misses = 0
        train_res = self._process_dataset(self.train_set, update=True)
        has_val = (self.validation_set is not None
                   and not self.validation_set.empty)
        self.did_validate = (has_val
                             and self.cur_epoch % self.validate_every == 0)
        val_res = (self._process_dataset(self.validation_set, update=False)
                   if self.did_validate else None)
        self.did_test = (self.test_set is not None and not self.test_set.empty
                         and self.cur_epoch % self.test_every == 0)
        test_res = (self._process_dataset(self.test_set, update=False)
                    if self.did_test else None)

        self.cur_training_error, self.cur_training_class_error = \
            self._fetch_metrics(self.train_set, *train_res)
        if self.did_validate:
            self.cur_validation_error, self.cur_validation_class_error = \
                self._fetch_metrics(self.validation_set, *val_res)
            if self.cur_validation_error < self.lowest_validation_error:
                self.lowest_validation_error = self.cur_validation_error
                self.epochs_since_lowest = 0
                self.best_params = _clone(self.params)
            else:
                self.epochs_since_lowest += self.validate_every
        elif not has_val:
            self.epochs_since_lowest = 0
            self.best_params = _clone(self.params)
        if self.did_test:
            self.cur_test_error, self.cur_test_class_error = \
                self._fetch_metrics(self.test_set, *test_res)

        if (self.epochs_since_lowest >= self.max_epochs_no_best
                or (self.max_epochs >= 0
                    and self.cur_epoch >= self.max_epochs)):
            self.params = self.best_params
            self.drop_graphs()
            self.finished = True
        return self.finished

    def exact_params(self, tree=None) -> Dict[str, Any]:
        """The current (or given) parameters as numpy arrays in the JAX
        package's tree layout, for Network.params and saving."""
        return params_to_numpy(self.params if tree is None else tree)

    # ------------------------------------------------------ state (autosave)
    def export_state(self) -> Dict[str, Any]:
        """Optimizer state for the autosave JSON, format-compatible with the
        reference's autosave files."""
        out = self.export_state_meta()
        out.update(self.export_state_arrays(self.exact_params(self.best_params),
                                            self.exact_params(self.velocity)))
        return out

    def export_state_meta(self) -> Dict[str, Any]:
        """The scalar half of export_state."""
        return {
            "optimizer_finished": self.finished,
            "optimizer_cur_epoch": self.cur_epoch,
            "optimizer_epochs_since_lowest_error": self.epochs_since_lowest,
            "optimizer_lowest_validation_error": self.lowest_validation_error,
            "optimizer_cur_training_error": self.cur_training_error,
            "optimizer_cur_validation_error": self.cur_validation_error,
            "optimizer_cur_test_error": self.cur_test_error,
            "optimizer_cur_training_class_error":
                self.cur_training_class_error,
            "optimizer_cur_validation_class_error":
                self.cur_validation_class_error,
            "optimizer_cur_test_class_error": self.cur_test_class_error,
        }

    def export_state_arrays(self, best_params, velocity) -> Dict[str, Any]:
        """The array half of export_state: the best weights and the momentum
        deltas, both numpy trees (exact_params), in the reference's
        layer-array layout. Touches no tensor, so it may run on a worker
        thread while the next epoch updates the live ones."""
        return {
            "optimizer_best_weights": self._params_to_layer_arrays(
                best_params),
            "steepest_descent_optimizer_weight_deltas":
                self._params_to_layer_arrays(velocity),
        }

    def _params_to_layer_arrays(self, params) -> List[np.ndarray]:
        """One flat [input|bias|internal] float64 array per layer position,
        empty for the input and post-output layers (Optimizer.cu:326-341
        exports m_bestWeights indexed by layer)."""
        out: List[np.ndarray] = []
        for s in self.net.specs:
            if s.name not in params:
                out.append(np.zeros(0))
                continue
            flat = (ioc.lstm_to_flat if s.type in ioc.LSTM_TYPES
                    else ioc.ff_to_flat)(params[s.name])
            out.append(np.concatenate(flat).astype(np.float64))
        return out

    def _params_from_layer_arrays(self, arrays) -> Dict[str, Any]:
        params = {}
        prev = None
        for s, arr in zip(self.net.specs, arrays):
            if s.type == "input" or s.type in ioc.POSTOUTPUT_TYPES:
                prev = s.size
                continue
            flat = np.asarray(arr, dtype=np.float32)
            if s.type in ioc.LSTM_TYPES:
                n_in, n_b = 4 * s.size * prev, 4 * s.size
                params[s.name] = ioc.lstm_from_flat(
                    flat[:n_in], flat[n_in:n_in + n_b], flat[n_in + n_b:],
                    prev, s.size, ioc.LSTM_TYPES[s.type])
            else:
                n_in = s.size * prev
                params[s.name] = ioc.ff_from_flat(
                    flat[:n_in], flat[n_in:n_in + s.size], prev, s.size)
            prev = s.size
        return params

    def import_state(self, doc: Dict[str, Any]) -> None:
        """Restore an autosave's optimizer state: the counters and errors,
        and the best weights and momentum deltas as fresh tensors on the
        trainer's device (the current weights are the autosave's network
        weights, which the Network was built from). Replays the training
        set's shuffles of the epochs done."""
        self.finished = bool(doc["optimizer_finished"])
        self.cur_epoch = int(doc["optimizer_cur_epoch"])
        self.epochs_since_lowest = int(
            doc["optimizer_epochs_since_lowest_error"])
        for key in ("lowest_validation_error", "cur_training_error",
                    "cur_validation_error", "cur_test_error",
                    "cur_training_class_error", "cur_validation_class_error",
                    "cur_test_class_error"):
            setattr(self, key, float(doc["optimizer_" + key]))
        self.best_params = params_from_numpy(self._params_from_layer_arrays(
            doc["optimizer_best_weights"]), self.device)
        self.velocity = params_from_numpy(self._params_from_layer_arrays(
            doc["steepest_descent_optimizer_weight_deltas"]), self.device)
        self.drop_graphs()
        if self.train_set is not None:
            self.train_set.skip_epochs(self.cur_epoch)
            if self.weight_noise_sigma > 0:
                self.skip_noise(self.cur_epoch)

    def skip_noise(self, epochs: int) -> float:
        """Discard the weight-noise draws of `epochs` training epochs (one
        draw of every parameter per training fraction), so that a restored
        run goes on with the noise of the uninterrupted one. Returns and
        prints the seconds it took."""
        t0 = time.perf_counter()
        n_params = sum(v.numel() for v in self._leaves(self.params))
        discard_normals(self._noise_rng,
                        epochs * self.train_set.num_fractions() * n_params)
        seconds = time.perf_counter() - t0
        print(f"Skipped the weight noise of {epochs} epochs in "
              f"{seconds:.2f} s")
        return seconds
