"""Parallelism of the port: sequence parallelism in one process
(`mesh.py`, `sequence.py`), data parallelism, single-host and multi-host,
one worker process per device over torch.distributed (`data.py`,
`launch.py`), and the two composed (DP x SP: a worker per seq mesh).
Tensor and pipeline parallelism are still to port (ROADMAP.md, queue
1)."""
