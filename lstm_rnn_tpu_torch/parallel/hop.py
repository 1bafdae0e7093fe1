"""The hop between two processes of a mesh that spans them.

Counterpart of the JAX package's `ppermute` of the carries
(lstm_rnn_tpu/parallel/sequence.py:150-151, :240-241) and of the stage
messages (parallel/pipeline.py's tick scan) where the two positions lie
on different processes (parallel/mesh.py `SpanMesh`); between two
positions of one process the hop stays a `.to(device)`.

A hop is a pair of autograd nodes, one on each side: `Chain.send` on the
process that owns the source position, `Chain.recv` on the one that owns
the destination. The forward sends the tensor; the backward sends its
cotangent the other way (the ppermute's transpose). Messages go over
torch.distributed point to point, in one process group a direction of
travel (`new_groups`: "up" from a lower mesh position to a higher one,
"down" the other way), so that no message waits behind one going the
other way. NCCL carries them between distinct GPUs; gloo on the CPU, and
gloo with CUDA tensors (two processes on one card, where NCCL refuses)
stages each message through host memory: the backend decides, not a
failure.

The backward must issue the hops of every process in an order that
cannot cross, whatever order the autograd engine picks for its other
nodes: a receive that blocks the engine's thread while the peer waits
for this process's own message would deadlock. So the hops of one step
form a chain, in the order the forward issued them: each hop takes the
previous hop's token (a zero scalar) and gives the next one, and the
step's loss adds the last token (`Chain.close`). The backward then runs
this process's hops in exactly the reverse of their forward order. Every
process's forward issues its hops in one global order (the wavefront's
rounds, the pipeline's ticks), so the reversed orders match too. The
chain starts from a zero taken from a parameter leaf (`anchor`),
which puts every hop on the path from the loss to the leaves: autograd
runs each one, also on a side that only sends and so has no output of
its own in the loss. The leaf's gradient gets an exact zero added.

`step_chain(mesh, params)` starts the chain of one step where the mesh
spans processes (parallel/sequence.py and parallel/pipeline.py call it).
`COUNTS` counts the messages this process sent and received, in the
forward and in the backward, so that tests can check the exact number.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# messages of this process: forward sends and receives, and the
# backward's cotangents sent and received
COUNTS = {"send": 0, "recv": 0, "send_grad": 0, "recv_grad": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def new_groups(backend: Optional[str] = None, timeout=None) -> dict:
    """The hops' process groups, one a direction of travel, over every
    rank of the default group, each hop bounded by `timeout` (a
    timedelta; every rank must call this, in the same order)."""
    import torch.distributed as dist
    return {"up": dist.new_group(backend=backend, timeout=timeout),
            "down": dist.new_group(backend=backend, timeout=timeout)}


def _staged(group, device: torch.device) -> bool:
    """A CUDA tensor over gloo goes through host memory."""
    import torch.distributed as dist
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _send(x: torch.Tensor, peer: int, group) -> None:
    import torch.distributed as dist
    x = x.detach().contiguous()
    if _staged(group, x.device):
        x = x.cpu()
    dist.send(x, peer, group=group)


def _recv(shape, dtype, device: torch.device, peer: int, group
          ) -> torch.Tensor:
    import torch.distributed as dist
    staged = _staged(group, device)
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if staged else device)
    dist.recv(buf, peer, group=group)
    return buf.to(device) if staged else buf


class _Send(torch.autograd.Function):
    """Forward: send x to `peer` over `fwd`. Backward: receive x's
    cotangent from it over `bwd`."""

    @staticmethod
    def forward(ctx, token, x, peer, fwd, bwd):
        _send(x, peer, fwd)
        COUNTS["send"] += 1
        ctx.meta = (tuple(x.shape), x.dtype, x.device, peer, bwd)
        return token.clone()

    @staticmethod
    def backward(ctx, g_token):
        shape, dtype, device, peer, bwd = ctx.meta
        g = _recv(shape, dtype, device, peer, bwd)
        COUNTS["recv_grad"] += 1
        return g_token, g, None, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive a [shape] tensor of dtype on `device` from `peer`
    over `fwd`. Backward: send its cotangent back over `bwd`."""

    @staticmethod
    def forward(ctx, token, shape, dtype, device, peer, fwd, bwd):
        y = _recv(shape, dtype, device, peer, fwd)
        COUNTS["recv"] += 1
        ctx.meta = (peer, bwd)
        return token.clone(), y

    @staticmethod
    def backward(ctx, g_token, g_y):
        peer, bwd = ctx.meta
        _send(g_y, peer, bwd)
        COUNTS["send_grad"] += 1
        return g_token, None, None, None, None, None, None


def anchor(leaves: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The chain's first token: an exact zero taken from the first leaf
    that records a gradient (a plain zero scalar when none does)."""
    if torch.is_grad_enabled():
        for t in leaves:
            if t.requires_grad:
                return (t.reshape(-1)[0] * 0).to(device)
    return torch.zeros((), device=device)


def step_chain(mesh, params) -> Optional["Chain"]:
    """The chain of one step on `mesh` from the parameter tree `params`
    (its first token on the process's first device), or None where the
    mesh does not span processes."""
    from lstm_rnn_tpu_torch.parallel.mesh import SpanMesh
    if not isinstance(mesh, SpanMesh):
        return None
    return Chain(mesh, anchor([v for layer in params.values()
                               for v in layer.values()], mesh.home))


class Chain:
    """The cross-process hops of one step on this process, in the order
    they are issued (see the module's docstring). `span` is the
    SpanMesh; `start` the first token (`anchor`)."""

    def __init__(self, span, start: torch.Tensor):
        self.span = span
        self.token = start

    def _route(self, i: int, j: int):
        """(peer rank, forward group, backward group) of the hop from
        position i to position j."""
        up, down = self.span.groups["up"], self.span.groups["down"]
        fwd, bwd = (up, down) if j > i else (down, up)
        peer = self.span.owners[j if self.span.owns(i) else i]
        return peer, fwd, bwd

    def send(self, x: torch.Tensor, i: int, j: int) -> None:
        """Hand x from position i (this process's) to position j."""
        self.token = _Send.apply(self.token, x, *self._route(i, j))

    def recv(self, i: int, j: int, shape, dtype) -> torch.Tensor:
        """The tensor position i hands to position j (this process's), on
        j's device."""
        self.token, y = _Recv.apply(self.token, tuple(shape), dtype,
                                    self.span[j], *self._route(i, j))
        return y

    def close(self, err: torch.Tensor) -> torch.Tensor:
        """err plus the last token (an exact zero), so that the backward
        reaches every hop of the step."""
        return err + self.token.to(err.device, err.dtype)
