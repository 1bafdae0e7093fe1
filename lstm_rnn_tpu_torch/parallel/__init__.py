"""Parallelism of the port: sequence, pipeline and tensor parallelism in
one process (`mesh.py`, `sequence.py`, `pipeline.py`, `tensor.py`), data
parallelism, single-host and multi-host, one worker process per device
over torch.distributed (`data.py`, `launch.py`), and data parallelism
composed with each of the three (DP x SP, DP x PP, DP x TP: a worker per
mesh), and a seq or pipe mesh over several processes (`mesh.SpanMesh`, a
worker a process, the carries and stage messages over torch.distributed
in `hop.py`)."""
