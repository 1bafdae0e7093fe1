"""Command line: `python -m lstm_rnn_tpu_torch.cli [options] [options-file]`.

Counterpart of lstm_rnn_tpu/cli.py (the `currennt` binary's behaviour,
`currennt/src/main.cpp`). This slice ports the forward-pass mode
(`--train false`): it runs the network over `--ff_input_file` and writes
the output layer's activations as single_csv, per-sequence csv or HTK
files. `--train true` raises NotImplementedError until the training step
is ported (ROADMAP.md).

Device: `--cuda true` (the default) or `--device cuda` runs on the GPU, the
LSTM layers through the Hopper kernel; a missing GPU is an error, not a
move to the CPU. `--device cpu` / `--cuda false` runs the plain PyTorch
twins. float32 matmuls run in true fp32: TF32 is switched off.
"""

from __future__ import annotations

import sys
import traceback
from typing import List, Optional

import numpy as np
import torch

from lstm_rnn_tpu_torch import io_currennt as ioc
from lstm_rnn_tpu_torch import writers
from lstm_rnn_tpu_torch.config import Config, parse_config
from lstm_rnn_tpu_torch.data.dataset import DataSet
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.utils.device import describe, select_device


def _load_dataset(cfg: Config) -> Optional[DataSet]:
    """The forward-pass set; input noise applies if sigma > 0
    (README:169-171). Fractions pad to their exact longest sequence unless
    --bucket_lengths asks for buckets: the JAX package always buckets here
    to bound its per-shape compiles, which the port does not have, and
    padding is numerically inert either way (get_outputs slices by true
    length)."""
    files = cfg.feedforward_input_files
    if not files:
        return None
    print("Loading ff set " + " ".join(f"'{f}'" for f in files) + " ...")
    ds = DataSet(files, parallel_sequences=cfg.parallel_sequences,
                 noise_deviation=cfg.input_noise_sigma,
                 input_left_context=cfg.input_left_context,
                 input_right_context=cfg.input_right_context,
                 output_time_lag=cfg.output_time_lag, seed=cfg.random_seed,
                 bucket_lengths=cfg.bucket_lengths, cache_path=cfg.cache_path)
    print("Loaded fraction:  100%")
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


def forward_mode(cfg: Config, device: torch.device) -> int:
    print(f"Reading network from '{cfg.network}'... ", end="")
    net_doc = ioc.load_network_json(cfg.network)
    print("done.\n")
    ff_set = _load_dataset(cfg)
    if ff_set is None:
        raise RuntimeError("no ff_input_file given")
    net = Network(net_doc["layers"], net_doc.get("weights"),
                  input_size_override=ff_set.input_pattern_size,
                  backend=cfg.lstm_backend, compute_dtype=cfg.compute_dtype)
    net.init_params(cfg.random_seed)
    _print_layers(net)
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

    lag = cfg.output_time_lag
    fmt = cfg.ff_output_format
    for frac_idx, frac in enumerate(ff_set.fractions(), start=1):
        print(f"Computing outputs for data fraction {frac_idx}...", end="",
              flush=True)
        with torch.inference_mode():
            x = torch.from_numpy(frac.inputs).to(device)
            pt = torch.from_numpy(frac.pattypes).to(device)
            y = net.apply(params, x, pt)
        tags, outs = net.get_outputs(y, frac.seq_info)
        if fmt == "single_csv":
            writers.write_single_csv(cfg.ff_output_file, tags, outs, lag,
                                     means, stdevs, append=frac_idx > 1)
        elif fmt == "csv":
            writers.write_csv(cfg.ff_output_file, tags, outs, lag, means,
                              stdevs)
        else:
            writers.write_htk(cfg.ff_output_file, tags, outs, lag, means,
                              stdevs, feature_period=cfg.feature_period,
                              kind=cfg.ff_output_kind)
        print(" done.")
    return 0


def _echo_settings(cfg: Config):
    """Startup echo of the effective settings (Configuration.cpp:312-369)."""
    print("Started in forward pass mode.")
    print(f"The forward pass output will be written to '{cfg.ff_output_file}'.")
    print()


def main(argv: Optional[List[str]] = None) -> int:
    cfg = parse_config(argv)
    if cfg.list_devices:
        n = torch.cuda.device_count()
        print(f"{n} devices found")
        for i in range(n):
            print(f"{i}: {torch.cuda.get_device_name(i)}")
        return 0
    if cfg.train:
        raise NotImplementedError(
            "--train true: the training step is not ported to PyTorch yet "
            "(ROADMAP.md, 'training step'); use lstm_rnn_tpu.cli to train")
    device = select_device(cfg.device, cfg.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(describe(device))
    print("TF32 is off: float32 matmuls run in true fp32.")
    _echo_settings(cfg)
    try:
        return forward_mode(cfg, device)
    except Exception as e:
        print(f"FAILED: {e}")
        traceback.print_exc(file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
