"""Command line: `python -m lstm_rnn_tpu_torch.cli [options] [options-file]`.

Counterpart of lstm_rnn_tpu/cli.py (the `currennt` binary's behaviour,
`currennt/src/main.cpp`):

- `--train true`: trains on `--train_file` (validating on `--val_file`,
  testing on `--test_file`) with momentum SGD, stochastic or batch, prints
  the epoch table, stops as the reference does and writes the best
  weights to `--save_network`; `--autosave` writes the network and the
  optimizer state after every epoch (`[prefix_]epochNNN.autosave`, the JSON
  dump on a worker thread while the next epoch trains), `--autosave_best`
  the best network at every new lowest validation error, and `--continue
  FILE` resumes from an autosave with the configuration it stores (the
  shuffles, the input noise and the weight noise of the epochs done are
  replayed or discarded, so that the resumed run equals the uninterrupted
  one); `--weight_noise_sigma`, `--input_noise_sigma` and `--init_rng
  currennt` draw the JAX package's streams;
- `--train false`: runs the network over `--ff_input_file` and writes the
  output layer's activations as single_csv, per-sequence csv or HTK files;
  with `--stream_chunk N` each fraction streams through a unidirectional
  net in N-frame chunks, each LSTM layer's state carried from chunk to
  chunk (online serving; the output equals the whole-sequence forward).

`--remat_blocks K` (train mode; forward mode ignores it, as the JAX CLI
does) checkpoints every LSTM layer's recurrence in K time blocks, so that
backward holds one block's residuals, and takes the plain softmax tail
(K5): on the card through the carry kernels, on the CPU through the scan
twins (models/lstm.py).

`--seq_devices N` (both modes) cuts every fraction's time axis into N
blocks on the first N GPUs (on the CPU with `--device cpu`: the CPU N
times) and runs the sequence-parallel path (parallel/sequence.py):
training through `Trainer(seq_mesh=)`, serving through `apply_seq`.

`--num_devices k` (both modes; 0: every GPU torch sees) runs data
parallelism, one worker process per GPU over a torch.distributed group
(parallel/launch.py, parallel/data.py): each fraction's batch split over
the workers in contiguous blocks, the gradients and the metrics summed
over them; on the CPU (`--device cpu`) k CPU workers over gloo. The
multi-host flags `--coordinator_address host:port --num_processes N
--process_id i` join N such processes, one per host, each with a worker
per local GPU. Global rank 0 prints the epoch table and writes every file
(the trained network, the autosaves, `.best.jsn`, the forward outputs,
which it gathers from the ranks); the others write nothing.

With the multi-host flags in train mode, `--seq_devices k` or
`--pipeline_devices k` where k is the global device count (every
process's GPUs, hosts of any size) trains the JAX package's 1-D seq or
pipe mesh over all of them: a worker a process drives the positions of
its own GPUs, in process order, and a carry or stage message between two
processes goes over torch.distributed (parallel/hop.py). The banners are
the one-process ones, printed by process 0.

The two compose (DP x SP): `--num_devices n --seq_devices N` with n
other than 1 and N (N must divide n), or `--seq_devices N` with the
multi-host flags in train mode, starts a worker per group of N GPUs
(n / N of them; on the CPU, CPU workers each with the CPU N times), and
each rank trains or serves its block of B sequence-parallel on its own
seq mesh (`Trainer(seq_mesh=, data_group=)`, `apply_seq`). With
`--stream_chunk` in forward mode, `--num_devices k` streams: every
fraction's B padded to parallel_sequences rounded up to a multiple of k,
each rank streaming its block chunk by chunk from its own carried state.
Multi-host serving is plain data-parallel serving only: sequence-parallel,
pipelined and streaming serving over several hosts are refused with the
JAX CLI's message.

`--pipeline_devices k` (both modes) splits the hidden layers into k
stages on the first k GPUs (the CPU k times with `--device cpu`) and runs
GPipe's schedule over `--pipeline_microbatches` microbatches
(parallel/pipeline.py): training through `Trainer(pipe_mesh=)`, serving
through `apply_pipelined`; `--num_devices n` above k composes it with
data parallelism (DP x PP), a worker per pipe mesh. `--model_devices k`
(train mode, `--num_devices n` > 1, k dividing n) shards every LSTM
layer's cells over k GPUs (parallel/tensor.py, `Trainer(model_mesh=)`),
one process for n == k, a worker per model mesh above (DP x TP); 0 picks
the count as the JAX CLI's heuristic does (`_auto_model_devices`). The
banners are the JAX CLI's ("Pipeline mesh", "DP x PP mesh", "DP x TP
mesh"); forward mode ignores --model_devices, as the JAX CLI does.

The JAX package's dispatch flags: in train mode `--device_cache true`
goes to the Trainer's data feed (trainer.py; the epoch row then ends with
the cache's `[cache hits/lookups hit, N MiB]`, as the JAX CLI's does);
`--fuse_fractions K` fuses the passes that the JAX Trainer fuses
(stochastic training without weight noise, every evaluation pass): on the
card each fraction steps through a CUDA graph of its shape's step
(graphs.py), and with `--device_cache true` and K at least the pass's
fraction count the pass runs as the stacked epoch; the JAX CLI's
"Epoch-resident fast path declined: ..." lines name a declined gate, once
each (trainer.py). The values are the unfused run's;
`--profile_dir DIR` traces the first epoch with torch.profiler into
`DIR/trace_rank<r>.json`, a file a rank; in both modes
`--compilation_cache_dir DIR` builds the kernel library and the native
runtime into DIR (ops/_build.py `use_dir`), in this process and in every
worker.

Device: `--cuda true` (the default) or `--device cuda` runs on the GPU, the
LSTM layers and the classification tail through the Hopper kernels; a
missing GPU is an error, not a move to the CPU. `--device cpu` /
`--cuda false` runs the plain PyTorch twins. float32 matmuls run in true
fp32: TF32 is switched off.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import traceback
from typing import List, Optional

import numpy as np
import torch

from lstm_rnn_tpu_torch import io_currennt as ioc
from lstm_rnn_tpu_torch import writers
from lstm_rnn_tpu_torch.config import Config, parse_config
from lstm_rnn_tpu_torch.data.dataset import DataSet
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.ops import _build, gemm
from lstm_rnn_tpu_torch.parallel import launch
from lstm_rnn_tpu_torch.parallel.data import gather_blocks, pad_batch
from lstm_rnn_tpu_torch.parallel.mesh import make_seq_mesh
from lstm_rnn_tpu_torch.parallel.pipeline import apply_pipelined, stage_ranges
from lstm_rnn_tpu_torch.parallel.sequence import apply_seq
from lstm_rnn_tpu_torch.trainer import Trainer
from lstm_rnn_tpu_torch.utils.device import describe, select_device


def _load_dataset(cfg: Config, which: str) -> Optional[DataSet]:
    """The train, val, test or ff ("ff") set, as the JAX CLI loads it:
    the training set truncates and shuffles as configured, every training
    -mode set is sorted by length; input noise applies to the training and
    forward-pass sets if sigma > 0 (README:169-171). Fractions pad to their
    exact longest sequence unless --bucket_lengths asks for buckets: the
    JAX package always buckets forward-pass sets to bound its per-shape
    compiles, which the port does not have, and padding is numerically
    inert either way (get_outputs slices by true length)."""
    frac_shuf = seq_shuf = False
    noise, trunc, sort = 0.0, 0, True
    if which == "train":
        files, frac = cfg.training_files, cfg.train_fraction
        frac_shuf, seq_shuf = cfg.shuffle_fractions, cfg.shuffle_sequences
        noise, trunc = cfg.input_noise_sigma, cfg.truncate_seq
    elif which == "val":
        files, frac = cfg.validation_files, cfg.val_fraction
    elif which == "test":
        files, frac = cfg.test_files, cfg.test_fraction
    else:
        files, frac = cfg.feedforward_input_files, 1.0
        noise, sort = cfg.input_noise_sigma, False
    if not files:
        return None
    print(f"Loading {which} set " + " ".join(f"'{f}'" for f in files)
          + " ...")
    ds = DataSet(files, parallel_sequences=cfg.parallel_sequences,
                 fraction=frac, trunc_seq_length=trunc,
                 fraction_shuffling=frac_shuf, sequence_shuffling=seq_shuf,
                 noise_deviation=noise,
                 input_left_context=cfg.input_left_context,
                 input_right_context=cfg.input_right_context,
                 output_time_lag=cfg.output_time_lag, sort_by_length=sort,
                 seed=cfg.random_seed, bucket_lengths=cfg.bucket_lengths,
                 bucket_major_shuffle=cfg.bucket_major_shuffle,
                 cache_path=cfg.cache_path)
    print(f"Loaded fraction:  {int(frac * 100)}%")
    print(f"Sequences:        {ds.total_sequences}")
    print(f"Sequence lengths: {ds.min_seq_length}..{ds.max_seq_length}")
    print(f"Total timesteps:  {ds.total_timesteps}")
    print()
    return ds


def _print_layers(net: Network):
    print("Layers:")
    total = 0
    for i, s in enumerate(net.specs):
        n_weights = 0
        line = f"({i}) {s.type} [size: {s.size}"
        if s.name in net.params:
            n_weights = sum(int(np.prod(p.shape))
                            for p in net.params[s.name].values())
            line += f", bias: {s.bias:.1f}, weights: {n_weights}"
        print(line + "]")
        total += n_weights
    print(f"Total weights: {total}\n")


def forward_mode(cfg: Config, device: torch.device, group=None) -> int:
    """Forward-pass mode on `device`; under a data group (DP serving, the
    JAX CLI's cli.py:712-750; DP x SP serving, :604-618; DP x PP serving,
    :587-603; DP streaming, :619-711) each rank computes its block of
    every fraction and rank 0 gathers the blocks and writes the files."""
    _use_build_dir(cfg)
    print(f"Reading network from '{cfg.network}'... ", end="")
    net_doc = ioc.load_network_json(cfg.network)
    print("done.\n")
    ff_set = _load_dataset(cfg, "ff")
    if ff_set is None:
        raise RuntimeError("no ff_input_file given")
    net = Network(net_doc["layers"], net_doc.get("weights"),
                  input_size_override=ff_set.input_pattern_size,
                  backend=cfg.lstm_backend, compute_dtype=cfg.compute_dtype)
    net.init_params(cfg.random_seed)
    _print_layers(net)
    chunk = cfg.stream_chunk
    if chunk > 0:
        net.init_stream_state(1, device)  # refuses a bidirectional net
        print(f"Streaming forward: {chunk}-frame chunks, carried LSTM "
              "state")
    axis, mesh = _mesh(cfg, device, group)
    if mesh is not None:
        device = mesh[0]
        if group is None:
            name = "Sequence-parallel" if axis == "seq" else "Pipeline"
            print(f"{name} mesh: {{'{axis}': {len(mesh)}}}")
    if group is not None:
        print(group.mesh_line("streaming mesh" if chunk > 0
                              else "serving mesh"))
    writes = group is None or group.is_coordinator
    params = net.device_params(device)

    means = stdevs = None
    if (cfg.revert_std and not ff_set.is_classification
            and ff_set.has_output_standardization):
        if ff_set.output_pattern_size != net.output_size:
            # silently broadcasting a mismatched mean/stdev vector over the
            # outputs would corrupt every written value
            raise RuntimeError(
                f"revert_std: the data's target size "
                f"({ff_set.output_pattern_size}) does not match the "
                f"network's output size ({net.output_size}); pass "
                "--revert_std false for dummy-target inference data")
        means, stdevs = ff_set.output_means, ff_set.output_stdevs
        print("Outputs will be scaled by mean and standard deviation specified in NC file.")

    for frac_idx, frac in enumerate(ff_set.fractions(), start=1):
        print(f"Computing outputs for data fraction {frac_idx}...", end="",
              flush=True)
        with torch.inference_mode():
            if group is not None:
                y = _apply_block(net, params, frac, group, chunk,
                                 _stream_width(cfg, group),
                                 cfg.pipeline_microbatches)
            else:
                x = torch.from_numpy(frac.inputs).to(device)
                pt = torch.from_numpy(frac.pattypes).to(device)
                if axis == "seq":
                    y = apply_seq(net, params, x, pt, mesh)
                elif axis == "pipe":
                    y = apply_pipelined(net, params, x, pt, mesh,
                                        cfg.pipeline_microbatches)
                elif chunk > 0:
                    y = _apply_streamed(net, params, x, pt, chunk)
                else:
                    y = net.apply(params, x, pt)
        if writes:
            _write_outputs(cfg, *net.get_outputs(y, frac.seq_info), means,
                           stdevs, append=frac_idx > 1)
        print(" done.")
    return 0


def _write_outputs(cfg: Config, tags, outs, means, stdevs, append: bool):
    """One fraction's outputs in --ff_output_format."""
    lag, fmt = cfg.output_time_lag, cfg.ff_output_format
    if fmt == "single_csv":
        writers.write_single_csv(cfg.ff_output_file, tags, outs, lag, means,
                                 stdevs, append=append)
    elif fmt == "csv":
        writers.write_csv(cfg.ff_output_file, tags, outs, lag, means, stdevs)
    else:
        writers.write_htk(cfg.ff_output_file, tags, outs, lag, means, stdevs,
                          feature_period=cfg.feature_period,
                          kind=cfg.ff_output_kind)


def _apply_block(net: Network, params, frac, group, chunk: int = 0,
                 width: int = 1, microbatches: int = 0):
    """DP serving of one fraction: B padded with PATTYPE_NONE rows to
    `width` (streaming) and to a multiple of the world size, this rank's
    block through the net (apply_seq on the rank's seq mesh under DP x
    SP; apply_pipelined over `microbatches` on its pipe mesh under DP x
    PP; chunk by chunk from a fresh state on the rank's device with
    `chunk`), the blocks gathered on rank 0 ([T, B, S] with the padding
    dropped; None on the other ranks)."""
    b = frac.pattypes.shape[1]
    x, _, pt = pad_batch(frac.inputs, None, frac.pattypes, max(width, b))
    x, _, pt = group.block(x, None, pt)
    x = torch.from_numpy(x).to(group.device)
    pt = torch.from_numpy(pt).to(group.device)
    if group.seq_mesh is not None:
        y = apply_seq(net, params, x, pt, list(group.seq_mesh))
    elif group.pipe_mesh is not None:
        y = apply_pipelined(net, params, x, pt, list(group.pipe_mesh),
                            microbatches)
    elif chunk > 0:
        y = _apply_streamed(net, params, x, pt, chunk)
    else:
        y = net.apply(params, x, pt)
    y = gather_blocks(y, group)
    return None if y is None else y[:, :b]


def _stream_width(cfg: Config, group) -> int:
    """The batch width every fraction streams at under DP streaming:
    parallel_sequences rounded up to a multiple of the world size, as the
    JAX CLI pads it (lstm_rnn_tpu/cli.py:636-639); 1 (no padding beyond
    the world size's) otherwise."""
    if cfg.stream_chunk <= 0:
        return 1
    width = max(1, cfg.parallel_sequences)
    return width + -width % group.size


def _mesh(cfg: Config, device: torch.device, group=None):
    """(axis, mesh) of the run: a composed rank's own seq, pipe or model
    mesh (its group's); else, for --seq_devices, --pipeline_devices or (in
    train mode) --model_devices k > 1, on `device`'s type the first k
    GPUs or the CPU k times; (None, None) without."""
    if group is not None:
        if group.span is not None:
            return group.span.axis, group.span
        for axis in ("seq", "pipe", "model"):
            mesh = getattr(group, f"{axis}_mesh")
            if mesh is not None:
                return axis, list(mesh)
        return None, None
    axis, k = launch.mesh_axis(cfg)
    if axis is None:
        return None, None
    return axis, make_seq_mesh(k, device.type)


def _check_stages(cfg: Config) -> None:
    """Refuse, before any worker starts and any fraction is computed, a
    pipeline of more stages than the net has hidden layers, in the JAX
    words (lstm_rnn_tpu/parallel/pipeline.py:49-56)."""
    if cfg.pipeline_devices > 1:
        layers = ioc.load_network_json(cfg.continue_file or cfg.network)[
            "layers"]
        stage_ranges(len(layers) - 2, cfg.pipeline_devices)


def _auto_model_devices(net: Network, parallel_sequences: int,
                        n_devices: int, device_type: str = "cuda") -> int:
    """--model_devices 0: the smallest tensor-parallel shard count (a
    divisor of the device count dividing every LSTM layer's cells) that
    brings each layer's cells per direction back inside the recurrence
    kernels' reach (ops/lstm_cell.py `recurrence_fits`, in training), the
    JAX CLI's heuristic (lstm_rnn_tpu/cli.py:228-275) with the port's
    bound in place of its VMEM one. 1 when nothing is too wide, when no
    valid count fits a layer (its scan route then runs on one device), on
    the CPU (as the JAX CLI off a TPU) and on the scan backend.
    parallel_sequences is the JAX signature's: the port's bound does not
    depend on it."""
    if n_devices <= 1 or device_type != "cuda" or net.backend == "scan":
        return 1
    from lstm_rnn_tpu_torch.ops.lstm_cell import recurrence_fits
    widths = [s.size // (2 if ioc.LSTM_TYPES[s.type] else 1)
              for s in net.specs[1:-1] if s.type in ioc.LSTM_TYPES]
    if not widths:
        return 1
    valid = [k for k in range(1, n_devices + 1)
             if n_devices % k == 0 and all(h % k == 0 for h in widths)]
    need = 1
    for h in widths:
        m = next((k for k in valid
                  if recurrence_fits(-(-h // k), net.compute_dtype, True)),
                 None)
        if m is None:
            return 1
        need = max(need, m)
    return need


def _resolve_model_devices(cfg: Config, device: torch.device) -> None:
    """Train mode's --model_devices 0, resolved before the run's workers
    start (an explicit pipeline or sequence request wins, as in the JAX
    CLI), with the JAX CLI's line when tensor parallelism engages."""
    if not cfg.train or cfg.model_devices != 0:
        return
    m = 1
    if cfg.pipeline_devices <= 1 and cfg.seq_devices <= 1:
        n = (cfg.num_devices if cfg.num_devices > 0 else
             (torch.cuda.device_count() if device.type == "cuda" else 1))
        doc = ioc.load_network_json(cfg.continue_file or cfg.network)
        net = Network(doc["layers"], backend=cfg.lstm_backend,
                      compute_dtype=cfg.compute_dtype)
        m = _auto_model_devices(net, cfg.parallel_sequences, n, device.type)
    cfg.args.model_devices = m
    if m > 1:
        print(f"Tensor parallelism auto-engaged: model_devices={m} (an "
              "LSTM layer is wider than the recurrence kernels take)")


def _check_servable(cfg: Config) -> None:
    """Refuse, before any worker starts, what forward mode cannot serve:
    sequence-parallel, pipelined or streaming serving over several hosts,
    in the JAX CLI's words (lstm_rnn_tpu/cli.py:538-546), and, for a run
    of several workers, --stream_chunk on a bidirectional net (the check
    init_stream_state makes in a one-process run)."""
    if cfg.num_processes > 1 and (cfg.seq_devices > 1
                                  or cfg.pipeline_devices > 1
                                  or cfg.stream_chunk > 0):
        raise RuntimeError(
            "pipeline/seq/streaming serving is single-host; multi-host "
            "forward passes run plain data-parallel serving (every host "
            "computes its batch shard, the coordinator writes)")
    if cfg.stream_chunk > 0 and cfg.num_devices != 1:
        layers = ioc.load_network_json(cfg.network)["layers"]
        Network(layers).init_stream_state(1, "cpu")


def _apply_streamed(net: Network, params, x, pt, chunk: int):
    """One fraction through the net in `chunk`-frame slices (the last may
    be shorter) from a fresh stream state; the outputs concatenated."""
    state = net.init_stream_state(x.shape[1], x.device)
    outs = []
    for lo in range(0, x.shape[0], chunk):
        y, state = net.apply_streaming(params, x[lo:lo + chunk],
                                       pt[lo:lo + chunk], state)
        outs.append(y)
    return torch.cat(outs)


def _use_build_dir(cfg: Config) -> None:
    """--compilation_cache_dir: build the kernel library and the native
    runtime into (and load them from) that directory, in this process (the
    CLI's and each worker's, before its first build)."""
    if cfg.compilation_cache_dir:
        _build.use_dir(cfg.compilation_cache_dir)


@contextlib.contextmanager
def _profiled(directory: str, device: torch.device, group=None):
    """Trace the body with torch.profiler (the CPU and, on a GPU, CUDA
    activities) and write a Chrome trace into `directory`, one file a
    rank: the JAX CLI's jax.profiler.trace of the first epoch."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    path = os.path.join(directory,
                        f"trace_rank{0 if group is None else group.rank}"
                        ".json")
    prof.export_chrome_trace(path)
    print(f"Wrote the trace of epoch 1 to '{path}'")


def _save_autosave(cfg: Config, net: Network, trainer: Trainer,
                   info_rows: str) -> threading.Thread:
    """Write this epoch's autosave: the network, the configuration, the
    epoch table so far and the optimizer state. Returns the worker thread
    that formats and writes the JSON (the caller joins it through
    _join_saver before the next save and before exiting: one write in
    flight, overlapping the next epoch).

    torch updates the parameters in place, so the epoch's weights, best
    weights and momentum deltas are copied to host numpy here, on the
    calling thread, before the worker starts: the worker never reads a
    live tensor. The terminal epoch's autosave stores the restored best
    weights (the reference restores inside Optimizer::train,
    Optimizer.cu:318, before main.cpp:276-277 saves the state): once
    trainer.finished, trainer.params are the best weights."""
    prefix = cfg.autosave_prefix
    name = (prefix + "_" if prefix else "") + \
        f"epoch{trainer.cur_epoch:03d}.autosave"
    extra = {"configuration": cfg.serialized_options,
             "info_rows": info_rows.replace("\n", ";;;")}
    extra.update(trainer.export_state_meta())
    params = trainer.exact_params()
    best = trainer.exact_params(trainer.best_params)
    velocity = trainer.exact_params(trainer.velocity)
    layers = net.layers_json()
    holder = []  # the worker's exception, re-raised by _join_saver

    def dump():
        try:
            t0 = time.perf_counter()
            extra.update(trainer.export_state_arrays(best, velocity))
            ioc.save_network_json(name, layers, params, extra=extra)
            t.seconds = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 (re-raised at the join)
            holder.append(e)

    t = threading.Thread(target=dump, name="autosave-dump")
    t.holder, t.path, t.seconds = holder, name, None
    t.start()
    return t


def _join_saver(t: threading.Thread) -> None:
    """Join an autosave dump thread, re-raising what it raised: a failed
    checkpoint write (disk full, permissions) aborts the run instead of
    training on with no autosaves landing."""
    t.join()
    if t.holder:
        raise t.holder[0]


def train_mode(cfg: Config, device: torch.device, group=None) -> int:
    """Train mode on `device`; under a data group every rank trains its
    block of each fraction and rank 0 prints and writes. --f32_matmul 3x
    turns on ops/gemm.py's F32_MATMUL_3X for the run, as the JAX CLI sets
    lstm_cell.F32_MATMUL_3X in train mode (lstm_rnn_tpu/cli.py:283-285);
    the switch is restored after it, so that one process may run the CLI
    again."""
    before = gemm.F32_MATMUL_3X
    gemm.F32_MATMUL_3X = cfg.f32_matmul == "3x"
    try:
        return _train(cfg, device, group)
    finally:
        gemm.F32_MATMUL_3X = before


def _train(cfg: Config, device: torch.device, group) -> int:
    _use_build_dir(cfg)
    network_file = cfg.continue_file or cfg.network
    print(f"Reading network from '{network_file}'... ", end="")
    net_doc = ioc.load_network_json(network_file)
    print("done.\n")
    train_set = _load_dataset(cfg, "train")
    if train_set is None:
        raise RuntimeError("no train_file given")
    val_set = _load_dataset(cfg, "val")
    test_set = _load_dataset(cfg, "test")
    net = Network(net_doc["layers"], net_doc.get("weights"),
                  input_size_override=train_set.input_pattern_size,
                  backend=cfg.lstm_backend, compute_dtype=cfg.compute_dtype)
    net.remat_blocks = cfg.remat_blocks
    if train_set.output_pattern_size != net.target_size:
        raise RuntimeError("Post output layer size != target pattern size "
                           "of the training set")
    net.init_params(cfg.random_seed, dist=cfg.weights_dist,
                    uniform_min=cfg.weights_uniform_min,
                    uniform_max=cfg.weights_uniform_max,
                    normal_mean=cfg.weights_normal_mean,
                    normal_sigma=cfg.weights_normal_sigma,
                    init_rng=cfg.init_rng)
    _print_layers(net)
    if cfg.optimizer != "steepest_descent":
        raise RuntimeError("Unknown optimizer type")

    axis, mesh = _mesh(cfg, device, group)
    if mesh is not None:
        device = mesh[0] if group is None else group.device
    if group is not None and group.span is None:
        print(group.mesh_line())
    elif axis == "seq":
        print(f"Sequence-parallel mesh: {{'seq': {len(mesh)}}} "
              "(time axis sharded)")
    elif axis == "pipe":
        print(f"Pipeline mesh: {{'pipe': {len(mesh)}}} "
              f"({len(net.specs) - 2} hidden layers over {len(mesh)} "
              "stages)")
    elif axis == "model":
        print(f"DP x TP mesh: {{'data': 1, 'model': {len(mesh)}}}")
    writes = group is None or group.is_coordinator
    max_epochs = cfg.max_epochs if cfg.max_epochs != 2**32 - 1 else -1
    trainer = Trainer(
        net, train_set, val_set, test_set,
        learning_rate=cfg.learning_rate, momentum=cfg.momentum,
        max_epochs=max_epochs, max_epochs_no_best=cfg.max_epochs_no_best,
        validate_every=cfg.validate_every, test_every=cfg.test_every,
        hybrid_online_batch=cfg.hybrid_online_batch,
        weight_noise_sigma=cfg.weight_noise_sigma, seed=cfg.random_seed,
        device=device, data_group=group,
        **({f"{axis}_mesh": mesh} if mesh is not None else {}),
        pipeline_microbatches=cfg.pipeline_microbatches,
        fuse_fractions=cfg.fuse_fractions, device_cache=cfg.device_cache)

    info_rows = ""
    if cfg.continue_file:
        print(f"Restoring state from '{cfg.continue_file}'...")
        info_rows = net_doc.get("info_rows", "").replace(";;;", "\n")
        trainer.import_state(net_doc)

    classification = net.is_classification
    print("Starting training...\n")
    print(" Epoch | Duration |  Training error  | Validation error |    "
          "Test error    | New best | Throughput")
    print("-------+----------+------------------+------------------+"
          "------------------+----------+-----------")
    sys.stdout.write(info_rows)
    err_space = "                  |"

    def fmt_err(err, cls_err):
        if classification:
            return f"{cls_err * 100:6.2f}%{err:10.3f} |"
        return f"{err:17.3f} |"

    saver = None  # the autosave dump in flight
    finished = trainer.finished  # a restored autosave may be finished
    while not finished:
        t0 = time.time()
        if cfg.profile_dir and trainer.cur_epoch == 0:
            with _profiled(cfg.profile_dir, device, group):
                finished = trainer.train_epoch()
        else:
            finished = trainer.train_epoch()
        duration = time.time() - t0
        row = f" {trainer.cur_epoch:5d} | {duration:8.1f} |"
        row += fmt_err(trainer.cur_training_error,
                       trainer.cur_training_class_error)
        row += (fmt_err(trainer.cur_validation_error,
                        trainer.cur_validation_class_error)
                if trainer.did_validate else err_space)
        row += (fmt_err(trainer.cur_test_error,
                        trainer.cur_test_class_error)
                if trainer.did_test else err_space)
        if trainer.did_validate:
            best = trainer.epochs_since_lowest == 0
            row += "  yes   " if best else "  no    "
            if best and cfg.autosave_best and writes:
                base = cfg.autosave_prefix or os.path.splitext(cfg.network)[0]
                net.params = trainer.exact_params(trainer.best_params)
                net.save(base + ".best.jsn")
        else:
            row += "        "
        fps = train_set.total_timesteps / max(duration, 1e-9)
        row += f"| {fps:,.0f} fr/s"
        if trainer.device_cache:
            st = trainer.device_cache_stats()
            lookups = st["hits"] + st["misses"]
            if lookups:
                row += (f"  [cache {st['hits']}/{lookups} hit, "
                        f"{st['bytes'] / 2**20:.0f} MiB]")
        row += "\n"
        sys.stdout.write(row)
        sys.stdout.flush()
        info_rows += row
        if cfg.autosave and writes:
            if saver is not None:
                _join_saver(saver)
            saver = _save_autosave(cfg, net, trainer, info_rows)

    if saver is not None:
        _join_saver(saver)  # the last autosave lands before the final save

    print()
    if trainer.epochs_since_lowest >= cfg.max_epochs_no_best:
        print(f"No new lowest error since {cfg.max_epochs_no_best} epochs. "
              "Training stopped.")
    else:
        print("Maximum number of training epochs reached. Training stopped.")
    if val_set is not None and not val_set.empty:
        print(f"Lowest validation error: {trainer.lowest_validation_error}")
    else:
        print(f"Final training set error: {trainer.cur_training_error}")
    print()
    print(f"Storing the trained network in '{cfg.save_network}'... ", end="")
    if writes:
        net.params = trainer.exact_params()
        net.save(cfg.save_network)
    print("done.")
    return 0


def _echo_settings(cfg: Config):
    """Startup echo of the effective settings (Configuration.cpp:312-369)."""
    if cfg.train:
        mode = "hybrid online/batch" if cfg.hybrid_online_batch else "batch"
        print(f"Started in {mode} training mode.")
        if cfg.shuffle_fractions:
            print(f"Mini-batches ({cfg.parallel_sequences} sequences each) "
                  "will be shuffled during training.")
        if cfg.shuffle_sequences:
            print("Sequences will be shuffled within and across mini-batches "
                  "during training.")
        if cfg.input_noise_sigma:
            print("Using input noise with a standard deviation of "
                  f"{cfg.input_noise_sigma}.")
        print(f"The trained network will be written to "
              f"'{cfg.save_network}'.")
        if os.path.exists(cfg.save_network):
            print(f"WARNING: The output file '{cfg.save_network}' already "
                  "exists. It will be overwritten!")
        if cfg.validation_files:
            print(f"Validation error will be calculated every "
                  f"{cfg.validate_every} epochs.")
        if cfg.test_files:
            print(f"Test error will be calculated every {cfg.test_every} "
                  "epochs.")
        stop = "Training will be stopped"
        if cfg.max_epochs != 2**32 - 1:
            stop += f" after {cfg.max_epochs} epochs or"
        print(stop + " if there is no new lowest validation error within "
              f"{cfg.max_epochs_no_best} epochs.")
        dist = (f"Normal distribution with mean={cfg.weights_normal_mean} "
                f"and sigma={cfg.weights_normal_sigma}"
                if cfg.weights_dist == "normal" else
                f"Uniform distribution with range "
                f"[{cfg.weights_uniform_min}, {cfg.weights_uniform_max}]")
        print(f"{dist}. Random seed: {cfg.random_seed}")
    else:
        print("Started in forward pass mode.")
        print(f"The forward pass output will be written to "
              f"'{cfg.ff_output_file}'.")
    print()


def main(argv: Optional[List[str]] = None) -> int:
    cfg = parse_config(argv)
    if cfg.list_devices:
        n = torch.cuda.device_count()
        print(f"{n} devices found")
        for i in range(n):
            print(f"{i}: {torch.cuda.get_device_name(i)}")
        return 0
    _use_build_dir(cfg)
    device = select_device(cfg.device, cfg.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(describe(device))
    print("TF32 is off: float32 matmuls run in true fp32.")
    _echo_settings(cfg)
    try:
        if not cfg.train:
            _check_servable(cfg)
        _check_stages(cfg)
        _resolve_model_devices(cfg, device)
        return launch.run(cfg, device,
                          train_mode if cfg.train else forward_mode)
    except Exception as e:
        print(f"FAILED: {e}")
        traceback.print_exc(file=sys.stderr)
        if isinstance(e, launch.WorkerError):
            sys.stderr.write(e.worker_traceback)
        return 2


if __name__ == "__main__":
    sys.exit(main())
