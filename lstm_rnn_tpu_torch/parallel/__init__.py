"""Parallelism of the port: sequence parallelism in one process
(`mesh.py`, `sequence.py`), and data parallelism, single-host and
multi-host, one worker process per device over torch.distributed
(`data.py`, `launch.py`). DP composed with SP, tensor and pipeline
parallelism are still to port (ROADMAP.md, queue 1)."""
