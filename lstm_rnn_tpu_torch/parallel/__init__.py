"""Parallelism of the port: sequence parallelism in one process
(`mesh.py`, `sequence.py`). Data, tensor and pipeline parallelism and
multi-host runs are still to port (ROADMAP.md, queue 1 items 4 and 7)."""
