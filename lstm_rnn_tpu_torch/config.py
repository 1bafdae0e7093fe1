"""Configuration: the CURRENNT flag surface on argparse.

Counterpart of lstm_rnn_tpu/config.py, with the same flags, defaults and
options-file parser (`option = value` per line, usable as positional
argument #1, CLI flags taking priority; `--continue <autosave>` re-parses
the configuration stored in the autosave,
Configuration.cpp:236-250).

Port-specific:
  --device       auto|cpu|cuda (auto follows --cuda); tpu is refused
  --lstm_backend auto|scan|pallas: pallas names the Hopper kernel
  --seq_devices  k > 1: sequence parallelism over a k-block seq mesh
                 (parallel/); k <= 1 is off. With --num_devices 1 or k
                 one process drives the mesh; with a larger count n (k
                 must divide it) or the multi-host flags, data
                 parallelism composed with it (DP x SP): a worker process
                 per seq mesh of k GPUs
  --num_devices  k: data parallelism, one worker process per GPU (0: every
                 GPU torch sees; with --device cpu, k CPU workers); in
                 forward mode also with --stream_chunk (data-parallel
                 streaming: each worker streams its block of B)
  --coordinator_address host:port, --num_processes N, --process_id i:
                 multi-host data parallelism, alone or with --seq_devices
                 in train mode (parallel/launch.py); in train mode with
                 --seq_devices or --pipeline_devices k = every host's
                 devices in all, one seq or pipe mesh over the hosts.
                 As in the JAX CLI, JAX_COORDINATOR_ADDRESS stands for the
                 first, and Open MPI's or SLURM's variables for the count
                 and the rank, binding the process to its local rank's GPU
                 (parallel/cluster.py)
  --f32_matmul 3x: in train mode with float32, the projections, weight
                 gradients, dx and the softmax tail's products as three
                 bf16 passes on the tensor cores (ops/gemm.py
                 F32_MATMUL_3X); nothing in bfloat16 mode or on the scan
                 route
  --pipeline_devices k > 1 (both modes): pipeline parallelism over k
                 stages (parallel/pipeline.py), --pipeline_microbatches
                 its microbatches; composed with --num_devices n as DP x
                 PP like --seq_devices
  --model_devices k > 1 (train mode): tensor parallelism, every LSTM
                 layer's cells over k devices (parallel/tensor.py);
                 needs --num_devices n > 1, DP x TP when n > k; 0 is the
                 JAX heuristic (cli.py `_auto_model_devices`: 1 on the
                 CPU); forward mode ignores it, as the JAX CLI does
Flags the port does not support yet raise a ValueError naming ROADMAP.md,
never silently ignored: --device tpu (and, in parallel/launch.py, the
cross-host groups the JAX package cannot train either: a composed group
whose row crosses a host, tensor parallelism across hosts).
--pipeline_devices 0 resolves to no parallelism, as the JAX CLI resolves
it. The combinations
the JAX CLI refuses are refused in its words: --seq_devices with
--stream_chunk, --model_devices or --pipeline_devices; --pipeline_devices
with --model_devices (train mode) or --stream_chunk (forward mode);
--model_devices above 1 on one device; a --seq_devices,
--pipeline_devices or --model_devices that does not divide --num_devices
(multi-host sequence-parallel, pipelined or streaming serving too, and a
stage count above the hidden layers', in cli.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import shlex
import sys
from typing import List, Optional


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got '{v}'")


DEFAULT_UINT_MAX = 2**32 - 1


def _bucket_arg(v: str):
    if isinstance(v, str) and v.lower() == "single":
        return "single"
    # '1'/'0' are the boolean spellings every other flag accepts — a
    # one-bucket inventory of length 1 is meaningless, so they are not
    # ambiguous with the explicit-inventory form
    if isinstance(v, str) and v in ("0", "1"):
        return _str2bool(v)
    if isinstance(v, str) and ("," in v or v.isdigit()):
        try:
            lengths = tuple(sorted(int(x) for x in v.split(",") if x))
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"bucket inventory expected (e.g. 384,512,768), got '{v}'")
        if not lengths or any(x <= 0 for x in lengths):
            raise argparse.ArgumentTypeError(
                f"bucket lengths must be positive, got '{v}'")
        return lengths
    return _str2bool(v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="currennt",
        description="lstm_rnn_tpu_torch - CURRENNT-compatible RNN toolkit on PyTorch + CUDA",
        add_help=True)
    p.add_argument("options_file", nargs="?", default=None,
                   help="reads the command line options from the file")

    g = p.add_argument_group("Common options")
    g.add_argument("--options_file", dest="options_file_flag", default=None)
    g.add_argument("--network", default="network.jsn")
    g.add_argument("--cuda", type=_str2bool, default=True,
                   help="accepted for compatibility; selects the accelerator")
    g.add_argument("--list_devices", type=_str2bool, default=False)
    g.add_argument("--parallel_sequences", type=int, default=1)
    g.add_argument("--random_seed", type=int, default=0)

    g = p.add_argument_group("Forward pass options")
    g.add_argument("--ff_output_format", default="single_csv",
                   choices=["single_csv", "csv", "htk"])
    g.add_argument("--ff_output_file", default="ff_output.csv")
    g.add_argument("--ff_output_kind", type=int, default=9)
    g.add_argument("--feature_period", type=float, default=10)
    g.add_argument("--ff_input_file", default="")
    g.add_argument("--revert_std", type=_str2bool, default=True)

    g = p.add_argument_group("Training options")
    g.add_argument("--train", type=_str2bool, default=False)
    g.add_argument("--stochastic", type=_str2bool, default=False)
    g.add_argument("--hybrid_online_batch", type=_str2bool, default=None,
                   help="same as --stochastic (for compatibility)")
    g.add_argument("--shuffle_fractions", type=_str2bool, default=False)
    g.add_argument("--shuffle_sequences", type=_str2bool, default=False)
    g.add_argument("--max_epochs", type=int, default=DEFAULT_UINT_MAX)
    g.add_argument("--max_epochs_no_best", type=int, default=20)
    g.add_argument("--validate_every", type=int, default=1)
    g.add_argument("--test_every", type=int, default=1)
    g.add_argument("--optimizer", default="steepest_descent",
                   choices=["steepest_descent", "rprop"])
    g.add_argument("--learning_rate", type=float, default=1e-5)
    g.add_argument("--momentum", type=float, default=0.9)
    g.add_argument("--weight_noise_sigma", type=float, default=0.0)
    g.add_argument("--save_network", default="trained_network.jsn")

    g = p.add_argument_group("Autosave options")
    g.add_argument("--autosave", type=_str2bool, default=False)
    g.add_argument("--autosave_best", type=_str2bool, default=False)
    g.add_argument("--autosave_prefix", default="")
    g.add_argument("--continue", dest="continue_file", default="")

    g = p.add_argument_group("Data file options")
    g.add_argument("--train_file", default="")
    g.add_argument("--val_file", default="")
    g.add_argument("--test_file", default="")
    g.add_argument("--train_fraction", type=float, default=1.0)
    g.add_argument("--val_fraction", type=float, default=1.0)
    g.add_argument("--test_fraction", type=float, default=1.0)
    g.add_argument("--truncate_seq", type=int, default=0)
    g.add_argument("--input_noise_sigma", type=float, default=0.0)
    g.add_argument("--input_left_context", type=int, default=0)
    g.add_argument("--input_right_context", type=int, default=0)
    g.add_argument("--output_time_lag", type=int, default=0)
    g.add_argument("--cache_path", default="")

    g = p.add_argument_group("Weight initialization options")
    g.add_argument("--weights_dist", default="uniform", choices=["uniform", "normal"])
    g.add_argument("--weights_uniform_min", type=float, default=-0.1)
    g.add_argument("--weights_uniform_max", type=float, default=0.1)
    g.add_argument("--weights_normal_sigma", type=float, default=0.1)
    g.add_argument("--weights_normal_mean", type=float, default=0.0)
    g.add_argument("--init_rng", default="numpy",
                   choices=["numpy", "currennt"],
                   help="'currennt' replays the reference's boost::mt19937 "
                        "init stream so same-seed runs start byte-identical "
                        "to the reference (uniform init only)")

    g = p.add_argument_group("Port options (extensions)")
    g.add_argument("--device", default="auto",
                   choices=["auto", "cpu", "cuda", "tpu"],
                   help="auto = cuda when --cuda is true, else cpu; cuda "
                        "raises when no GPU is visible")
    g.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel devices (GPUs, one worker process "
                        "each), 0 = all; on the CPU, CPU workers")
    g.add_argument("--model_devices", type=int, default=1,
                   help="tensor-parallel shard count for LSTM cells (train "
                        "mode; must divide num_devices, DP x TP when "
                        "num_devices exceeds it); 0 = auto (1 on the CPU)")
    g.add_argument("--pipeline_devices", type=int, default=1,
                   help="pipeline-parallel stage count: the hidden layers "
                        "in N contiguous stages, one a device, over "
                        "microbatches of the fraction's batch (GPipe)")
    g.add_argument("--pipeline_microbatches", type=int, default=0,
                   help="microbatches per pipeline data shard (0 = stage "
                        "count)")
    g.add_argument("--stream_chunk", type=int, default=0,
                   help="forward mode: stream each fraction through a "
                        "unidirectional net in N-frame chunks with carried "
                        "LSTM state (0 = whole sequences)")
    g.add_argument("--remat_blocks", type=int, default=0,
                   help="training only: gradient checkpointing of the "
                        "recurrence in K time blocks")
    g.add_argument("--seq_devices", type=int, default=1,
                   help="sequence-parallel shard count: the time axis of "
                        "every fraction in this many blocks, one per device")
    g.add_argument("--bucket_lengths", type=_bucket_arg, default=False,
                   help="false = exact lengths, true = power-of-2 bucket "
                        "inventory, single = one bucket at the corpus max, "
                        "or an explicit comma-separated inventory (e.g. "
                        "384,512,768); fractions above the largest bucket "
                        "pad to their exact length. Padding is numerically "
                        "inert")
    g.add_argument("--bucket_major_shuffle", type=_str2bool, default=True,
                   help="with bucket_lengths + shuffle_fractions: shuffle "
                        "within each length bucket but emit buckets "
                        "contiguously (false = unrestricted order)")
    g.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="float32 = true fp32 (TF32 off); bfloat16 = bf16 "
                        "matmul operands, f32 state and accumulation")
    g.add_argument("--f32_matmul", default="6x", choices=["6x", "3x"],
                   help="6x = true fp32; 3x = the f32 products as three "
                        "bf16 passes (hi/lo split) on the tensor cores")
    g.add_argument("--lstm_backend", default="auto",
                   choices=["auto", "scan", "pallas"],
                   help="LSTM recurrence: auto/pallas = the Hopper kernel "
                        "on CUDA (its plain twin on CPU), scan = the plain "
                        "PyTorch scan")
    g.add_argument("--fuse_fractions", type=int, default=1,
                   help="K > 1: stochastic training without weight "
                        "noise and evaluation step through CUDA graphs of "
                        "the step (one a fraction shape); with "
                        "--device_cache and K >= the pass's fractions, the "
                        "stacked epoch")
    g.add_argument("--device_cache", type=_str2bool, default=None,
                   help="training only: keep assembled fractions on the "
                        "device across epochs (default off)")
    g.add_argument("--compilation_cache_dir", default="",
                   help="build directory of the CUDA kernel library and "
                        "the native runtime (default: the package's "
                        "_build/)")
    g.add_argument("--profile_dir", default="",
                   help="training only: torch.profiler Chrome trace of the "
                        "first epoch, a file a rank")

    g = p.add_argument_group("Multi-host options (extensions)")
    g.add_argument("--coordinator_address", default="",
                   help="multi-host coordinator host:port (process 0 "
                        "serves the rendezvous there); default "
                        "JAX_COORDINATOR_ADDRESS")
    g.add_argument("--num_processes", type=int, default=0,
                   help="multi-host process count (0 = from Open MPI's or "
                        "SLURM's environment)")
    g.add_argument("--process_id", type=int, default=-1,
                   help="multi-host rank of this process, 0..N-1 (-1 = "
                        "from Open MPI's or SLURM's environment)")
    return p


def _split_files(s: str) -> List[str]:
    return [f for f in s.replace(";", ",").split(",") if f]


@dataclasses.dataclass(frozen=True)
class Config:
    """Immutable parsed configuration; `serialized_options` is the flag
    string an autosave stores and `--continue` re-parses."""
    args: argparse.Namespace
    serialized_options: str

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "args"), name)

    @property
    def hybrid_online_batch(self) -> bool:
        a = self.args
        if a.hybrid_online_batch is not None:
            return a.hybrid_online_batch
        return a.stochastic

    @property
    def training_files(self) -> List[str]:
        return _split_files(self.args.train_file)

    @property
    def validation_files(self) -> List[str]:
        return _split_files(self.args.val_file)

    @property
    def test_files(self) -> List[str]:
        return _split_files(self.args.test_file)

    @property
    def feedforward_input_files(self) -> List[str]:
        return _split_files(self.args.ff_input_file)


def _read_options_file(path: str) -> List[str]:
    """`option = value` per line; '#' comments (Configuration.cpp options-file
    format via boost program_options parse_config_file)."""
    argv = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise ValueError(f"bad options file line: {line!r}")
            k, v = line.split("=", 1)
            argv += [f"--{k.strip()}", v.strip()]
    return argv


def parse_config(argv: Optional[List[str]] = None) -> Config:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    ns = parser.parse_args(argv)
    opts_file = ns.options_file or ns.options_file_flag
    if opts_file:
        # CLI takes priority over the options file (README:110-117): parse
        # file first, then re-apply the CLI on top — with the options-file
        # reference itself removed (for the --options_file flag form, BOTH
        # the flag token and its value; naive value filtering left a bare
        # '--options_file' behind and crashed argparse)
        # whether the CLI used the positional form must be captured BEFORE
        # ns is rebound to the options-file parse (where the positional is
        # never set — the file expands to --flag tokens only)
        used_positional = bool(ns.options_file)
        file_argv = _read_options_file(opts_file)
        ns = parser.parse_args(file_argv)
        cli_argv = []
        strip_positional = opts_file if used_positional else None
        skip_next = False
        for a in argv:
            if skip_next:
                skip_next = False
                continue
            if a == "--options_file":
                skip_next = True
                continue
            if a.startswith("--options_file="):
                continue
            if strip_positional is not None and a == strip_positional:
                strip_positional = None  # the positional form, once
                continue
            cli_argv.append(a)
        ns = parser.parse_args(cli_argv, namespace=ns)

    if ns.continue_file:
        # --continue ignores all other flags: re-parse the configuration
        # stored in the autosave file (Configuration.cpp:236-250).
        import json
        with open(ns.continue_file) as f:
            doc = json.load(f)
        stored = doc.get("configuration", "")
        cont = ns.continue_file
        # process-identity flags are NOT stored in autosaves (each resumed
        # job has its own coordinator/rank) — carry the live CLI values over
        coord, nproc, pid = ns.coordinator_address, ns.num_processes, ns.process_id
        ns = parser.parse_args(shlex.split(stored))
        ns.continue_file = cont
        ns.coordinator_address, ns.num_processes, ns.process_id = coord, nproc, pid

    # validation (Configuration.cpp:264-310)
    for frac, nm in ((ns.train_fraction, "training"), (ns.val_fraction, "validation"),
                     (ns.test_fraction, "test")):
        if not (0 < frac <= 1):
            raise ValueError(f"Invalid {nm} set fraction. Should be 0 < x <= 1")
    for val, nm in ((ns.validate_every, "validate_every"),
                    (ns.test_every, "test_every")):
        if val < 1:
            raise ValueError(f"Invalid {nm}: must be >= 1")

    # random seed auto-generation (Configuration.cpp:272-274)
    if ns.random_seed == 0:
        import random
        ns.random_seed = random.SystemRandom().randrange(1, 2**32)

    _check_supported(ns)
    return Config(args=ns, serialized_options=serialize_options(ns))


_SERIALIZE_SKIP = {"options_file", "options_file_flag", "continue_file",
                   "list_devices",
                   # process identity is per-job, never replayed from an
                   # autosave (--continue keeps the live values instead)
                   "coordinator_address", "num_processes", "process_id",
                   "local_device_ids"}


def serialize_options(ns: argparse.Namespace) -> str:
    """Flatten the effective options to a flag string stored in autosaves
    (Configuration.cpp:47-67)."""
    parts = []
    for k, v in sorted(vars(ns).items()):
        if k in _SERIALIZE_SKIP or v is None:
            continue
        if isinstance(v, bool):
            v = "true" if v else "false"
        elif isinstance(v, tuple):  # explicit bucket inventory
            v = ",".join(str(x) for x in v)
        parts.append(f"--{k} {shlex.quote(str(v))}")
    return " ".join(parts)


def _visible_devices(ns: argparse.Namespace) -> int:
    """The devices `--num_devices 0` means (every one available, as in
    the JAX CLI): the GPUs torch sees, or 1 on the CPU."""
    if ns.device == "cpu" or (ns.device == "auto" and not ns.cuda):
        return 1
    import torch
    return max(1, torch.cuda.device_count())


def _check_supported(ns: argparse.Namespace) -> None:
    """Refuse the flags whose features the port does not have yet, and
    the combinations the JAX CLI refuses (lstm_rnn_tpu/cli.py:336-358,
    :577-586; parallel/mesh.py:58-93). Device counts resolve as the JAX
    CLI resolves them: --seq_devices and --pipeline_devices count only
    above 1, --model_devices 0 is the TP heuristic (resolved in cli.py),
    and --num_devices 0 is every device available. The multi-host
    settings resolve first, from the flags and the cluster's environment
    (parallel/cluster.py), into the namespace: the coordinator, the count,
    the rank and `local_device_ids` (None: every local device)."""
    from lstm_rnn_tpu_torch.parallel import cluster
    found = cluster.resolve(ns.coordinator_address, ns.num_processes,
                            ns.process_id)
    ns.coordinator_address = found.coordinator
    ns.num_processes, ns.process_id = found.num_processes, found.process_id
    ns.local_device_ids = found.local_device_ids
    multihost = bool(ns.coordinator_address)
    if multihost and not (ns.num_processes >= 1
                          and 0 <= ns.process_id < ns.num_processes):
        raise ValueError(
            "--coordinator_address needs --num_processes N >= 1 and "
            f"--process_id in 0..N-1 (got {ns.num_processes}, "
            f"{ns.process_id})")
    if not multihost and (ns.num_processes > 1 or ns.process_id > 0):
        raise ValueError("--num_processes/--process_id need "
                         "--coordinator_address")
    sp = max(1, ns.seq_devices)
    pp = max(1, ns.pipeline_devices)
    # forward mode never reads --model_devices (lstm_rnn_tpu/cli.py:536+)
    tp = ns.model_devices if ns.train else 1
    if sp > 1 and (ns.model_devices > 1 or pp > 1):
        raise ValueError("seq_devices > 1 does not combine with "
                         "model_devices or pipeline_devices")
    if ns.train and pp > 1 and tp > 1:
        raise ValueError("pipeline_devices > 1 does not combine with "
                         "model_devices")
    if (sp > 1 or (pp > 1 and not ns.train)) and ns.stream_chunk > 0:
        raise ValueError("stream_chunk does not combine with "
                         "pipeline_devices or seq_devices")
    n = ns.num_devices if ns.num_devices > 0 else _visible_devices(ns)
    if tp > 1 and n <= 1 and not multihost:
        raise ValueError("model_devices > 1 requires num_devices > 1")
    # the JAX package's composed_mesh and make_mesh_2d (parallel/mesh.py:
    # 58-93); a multi-host run counts each host's devices
    # (parallel/launch.py)
    for flag, k in (("seq_devices", sp), ("pipeline_devices", pp),
                    ("model_devices", tp)):
        if k > 1 and not multihost and n > 1 and n != k and n % k:
            raise ValueError(f"{flag}={k} must divide num_devices={n}")
    if ns.device == "tpu":
        raise ValueError(
            "--device tpu is not supported by the PyTorch port yet; see "
            "ROADMAP.md (the JAX package (lstm_rnn_tpu))")
