"""One process of a multi-host run of the port's CLI whose host holds N
CPU devices: `python tests/torch_span_runner.py N [CLI flags]`.

The CPU has no device count of its own, so this gives the process its
local device list through parallel/launch.py `local_devices` (N times
the CPU) and then runs `lstm_rnn_tpu_torch.cli.main` with the flags.
tests/test_torch_cross_host.py starts one such process a host, with the
multi-host flags, to train a seq or pipe mesh over hosts of any size.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from lstm_rnn_tpu_torch import cli  # noqa: E402
from lstm_rnn_tpu_torch.parallel import launch  # noqa: E402


def main(argv) -> int:
    n = int(argv[0])
    launch.local_devices = lambda device_type, k=1: [torch.device("cpu")] * n
    return cli.main(argv[1:])


if __name__ == "__main__":  # the workers spawned re-import this module
    sys.exit(main(sys.argv[1:]))
