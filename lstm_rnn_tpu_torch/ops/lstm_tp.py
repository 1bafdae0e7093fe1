"""The tensor-parallel LSTM layer on the GPUs of a model mesh: the
wrappers of the Hopper kernels K8f and K8b (csrc/lstm_tp.cu), their plain
twins, and the autograd Function that joins them.

Neither kernel replaces a pallas_call: the JAX package's tensor-parallel
layer (lstm_rnn_tpu/parallel/tensor.py `lstm_forward_tp`) is one
lax.scan of the CURRENNT cell inside shard_map with an all_gather a step,
and its BPTT the reduce_scatter that autodiff makes of it. K8f and K8b
are the port's counterpart of that one compiled program:

- `lstm_tp_fwd` (K8f, tp_rec_kernel; save=True for training): one launch
  a layer on each GPU of the mesh, covering every shard the GPU holds and
  both directions; each step every shard's h slice goes into the layer's
  output on every GPU (peer stores: the all_gather);
- `lstm_tp_bwd` (K8b, tp_bptt_kernel): one launch a layer and GPU; each
  step every shard's partial recurrent error over all H goes, slice by
  slice, to the GPU that owns those cells (the reduce_scatter), and the
  cell-error step emits the clipped deltas `da`.

`LstmTPFused` joins them: its forward is K8f with the residuals, its
backward K8b, then dW_rec = sum_t h_{t-1}^T da(t) and the peephole sums
as plain products over the saved history. The shard's input projection
and its gradients (dx, dW_in, the bias) stay outside, plain products, as
the JAX package leaves its einsums outside any kernel
(parallel/tensor.py).

Layouts (shard i of n, w = H / n cells, D directions, scan order: step s
of direction 1 is time T - 1 - s): acts[i] [T, D, B, 4, w] f32 (the
projection plus bias), w_rec[i] [D, H, 4, w], peep[i] [D, 3, w], the
validity mask [T, D, B] f32 on each shard's device; the output [T, B,
D*H] in natural time, one replica a distinct GPU of the mesh. The
residuals: c[i] [T, D, B, w] and the gates (ni, ig, fg, og) [T, D, B, 4,
w], both times the validity.

On CUDA tensors each wrapper launches its kernels or raises; on CPU
tensors it runs its twin: `lstm_tp_fwd_reference` (the loop that was the
port's tensor-parallel layer before the kernels) and
`lstm_tp_bptt_reference` (the kernel's algorithm step by step: a partial
a shard, the reduce_scatter, the cell-error step).

A mesh's launches share a `MeshContext`: peer access between every pair
of its GPUs (enabled once; a pair without it is refused), each GPU's
flag slots and sequence number (csrc/lstm_tp.cu: stamps that survive a
CUDA graph's replays), a host-mapped error record and a stream a GPU. A
GPU's kernel runs on its context stream, which first waits for the
current stream of EVERY GPU of the mesh as it stands before any of the
layer's launches: no launch of the layer depends on another's (their
spin waits would deadlock, eagerly and in a graph), and no peer store
lands in memory that another GPU's earlier work still reads. The
current streams then wait for the context streams. A wait that passes
`WAIT_BOUND_S` ends the launch with an error record, which the next
launch of the mesh, or `check`, raises naming the layer and the GPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from lstm_rnn_tpu_torch.ops.activations import tanh2
from lstm_rnn_tpu_torch.ops.lstm_cell import _raise_on, lstm_cell_step

# the longest a K8 kernel waits for a peer's step (seconds): far above
# the host's gap between its launches on the mesh's GPUs
WAIT_BOUND_S = 10.0
# flag slots a GPU keeps per mesh: directions x row groups x the writers
# of a group (csrc/lstm_tp.cu mesh_ok)
FLAG_SLOTS = 1 << 16
# a tile's cells (kTpCells), the shards one GPU holds, the GPUs and the
# shards of a mesh (kTpMaxLocal, kTpMaxGpus, kTpMaxShards)
TILE_CELLS = 32
MAX_LOCAL, MAX_GPUS, MAX_SHARDS = 16, 8, 64
# cudaErrorCooperativeLaunchTooLarge: more tiles than the card holds at
# once; cudaErrorPeerAccessUnsupported
_TOO_LARGE, _NO_PEER = 82, 217


# ---------------------------------------------------------------- twins
def _gather(h_new, gpus):
    """The all_gather: every distinct device's full h [D, B, H] of a step
    from the shards' slices, in shard order."""
    return [torch.cat([h.to(dev) for h in h_new], dim=-1) for dev in gpus]


def _tp_loop(acts, w_recs, peeps, masks, mesh, gclip=None, save=False):
    """The tensor-parallel recurrence, a Python loop over time: each step
    every shard's gates from the full h of the step before (on its
    device), the CURRENNT cell (ops/lstm_cell.py `lstm_cell_step`), h and
    c times the step's validity, then the full h assembled on every
    distinct device. Differentiable (gclip: the delta clip, as the scan
    route wraps it). Returns (outputs [T, B, D*H] a distinct device, c,
    gates per shard or None)."""
    gpus = list(dict.fromkeys(mesh))
    gpu_of = [gpus.index(dev) for dev in mesh]
    T, D, B, _, _ = acts[0].shape
    ws = [a.shape[-1] for a in acts]
    H = sum(ws)
    h_full = [acts[0].new_zeros(D, B, H).to(dev) for dev in gpus]
    c = [a.new_zeros(D, B, w) for a, w in zip(acts, ws)]
    hist = [[] for _ in gpus]
    c_res = [[] for _ in mesh] if save else None
    g_res = [[] for _ in mesh] if save else None
    for t in range(T):
        h_new = []
        for i in range(len(mesh)):
            w = ws[i]
            a = acts[i][t] + torch.bmm(
                h_full[gpu_of[i]], w_recs[i].reshape(D, H, 4 * w)).view(
                    D, B, 4, w)
            h_i, c_i, gates = lstm_cell_step(a, c[i], peeps[i], False, gclip)
            m = masks[i][t][..., None]
            h_new.append(h_i * m)
            c[i] = c_i * m
            if save:
                c_res[i].append(c[i])
                g_res[i].append(torch.stack(gates, dim=2) * m[:, :, None])
        h_full = _gather(h_new, gpus)
        for j in range(len(gpus)):
            hist[j].append(h_full[j])
    outs = []
    for j in range(len(gpus)):
        ys = torch.stack(hist[j])  # [T, D, B, H]
        outs.append(torch.cat([ys[:, 0], ys.flip(0)[:, 1]], dim=-1)
                    if D == 2 else ys[:, 0])
    if not save:
        return outs, None, None
    return (outs, [torch.stack(v) for v in c_res],
            [torch.stack(v) for v in g_res])


def lstm_tp_fwd_reference(acts, w_recs, peeps, masks, mesh, save=False):
    """K8f's plain twin: `_tp_loop` without the delta clip (a forward).
    Returns (one output a distinct device, c, gates; None unless save)."""
    return _tp_loop(acts, w_recs, peeps, masks, mesh, None, save)


def lstm_tp_bptt_reference(gates, cs, w_recs, peeps, dys, masks, mesh,
                           clip=True):
    """K8b's plain twin, the kernel's algorithm step by step. dys[i]
    [T, D, B, w] is shard i's output cotangent in scan order (every
    replica's summed). Each step (BPTT order) shard i takes e = dys[i][s]
    plus the partials the shards sent it the step before (in shard
    order), runs the cell-error step of csrc/lstm_bwd.cu (the UNCLIPPED
    og delta into the cell-state error, the +-1 clip, times the
    validity), and sends each shard j the slice j of its partial
    da_i(s) . W_rec_i^T for step s - 1: the reduce_scatter. Returns da
    [T, D, B, 4, w] a shard."""
    n = len(mesh)
    T, D, B, _, w = gates[0].shape
    H = n * w
    da = [torch.empty_like(g) for g in gates]
    dn = [g.new_zeros(D, B, 4, w) for g in gates]
    cse = [g.new_zeros(D, B, w) for g in gates]
    fgn = [g.new_zeros(D, B, w) for g in gates]
    parts = None  # parts[j][i]: shard j's partial for shard i's cells
    for it in range(T):
        s = T - 1 - it
        for i in range(n):
            e = dys[i][s]
            if parts is not None:
                for j in range(n):
                    e = e + parts[j][i]
            ni, ig, fg, og = gates[i][s].unbind(2)
            cc = cs[i][s]
            c_prev = cs[i][s - 1] if s > 0 else torch.zeros_like(cc)
            m = masks[i][s][..., None]
            p_ig, p_fg, p_og = (peeps[i][:, None, q] for q in range(3))
            tanh_c = tanh2(cc)
            og_delta = og * (1.0 - og) * tanh_c * e
            cs_err = (og * (1.0 - tanh_c * tanh_c) * e + p_og * og_delta
                      + fgn[i] * cse[i] + p_ig * dn[i][:, :, 1]
                      + p_fg * dn[i][:, :, 2])
            d = [ig * (1.0 - ni * ni) * cs_err, ig * (1.0 - ig) * ni * cs_err,
                 fg * (1.0 - fg) * c_prev * cs_err, og_delta]
            if clip:
                d = [torch.clamp(v, -1.0, 1.0) for v in d]
            dn[i] = torch.stack(d, dim=2) * m[:, :, None]
            da[i][s] = dn[i]
            cse[i] = cs_err * m
            fgn[i] = fg * m
        if s == 0:
            break
        parts = []
        for i in range(n):
            partial = torch.bmm(dn[i].reshape(D, B, 4 * w),
                                w_recs[i].reshape(D, H, 4 * w).transpose(1, 2))
            parts.append([partial[..., j * w:(j + 1) * w].to(mesh[j])
                          for j in range(n)])
    return da


def tp_param_grads(y, da, c):
    """A shard's dW_rec [D, H, 4, w] and dpeep [D, 3, w] after the loop,
    plain products over the saved history: dW_rec = sum over steps of
    h_prev^T da (h_prev the full output of the step before in scan order,
    from the shard's device's replica y [T, B, D*H]), dpeep = [sum c_prev
    da_ig, sum c_prev da_fg, sum c da_og]."""
    T, D, B, _, w = da.shape
    H = y.shape[-1] // D
    hist = torch.stack([y[:, :, :H]] + ([y[:, :, H:].flip(0)] if D == 2
                                        else []))  # [D, T, B, H]
    h_prev = torch.cat([hist.new_zeros(D, 1, B, H), hist[:, :-1]], dim=1)
    dad = da.permute(1, 0, 2, 3, 4).reshape(D, T * B, 4 * w)
    dw_rec = torch.bmm(h_prev.reshape(D, T * B, H).transpose(1, 2), dad)
    c_prev = torch.cat([c.new_zeros(1, D, B, w), c[:-1]])
    dpeep = torch.stack([(c_prev * da[:, :, :, 1]).sum((0, 2)),
                         (c_prev * da[:, :, :, 2]).sum((0, 2)),
                         (c * da[:, :, :, 3]).sum((0, 2))], dim=1)
    return dw_rec.view(D, H, 4, w), dpeep


# ------------------------------------------------------------- the mesh
class MeshContext:
    """What a model mesh's K8 launches share on its GPUs (see the module
    docstring): `gpus` the distinct GPUs in mesh order, `gpu_of[i]` shard
    i's GPU index, each GPU's flag slots and state ({seq, blocks done,
    poisoned}), a host-mapped error record [gpus, 4] and a stream a GPU;
    the layers' names by id (the error record names the layer)."""

    def __init__(self, mesh: Sequence[torch.device]):
        from lstm_rnn_tpu_torch.ops import _build
        lib = _build.load()
        self.mesh = list(mesh)
        self.gpus = list(dict.fromkeys(self.mesh))
        self.gpu_of = [self.gpus.index(d) for d in self.mesh]
        if len(self.gpus) > MAX_GPUS or len(self.mesh) > MAX_SHARDS:
            raise ValueError(f"a model mesh of {len(self.mesh)} shards on "
                             f"{len(self.gpus)} GPUs: the TP kernels take "
                             f"at most {MAX_SHARDS} shards on {MAX_GPUS} "
                             "GPUs")
        for a in self.gpus:
            for b in self.gpus:
                if a == b:
                    continue
                err = lib.lstm_tp_peer(a.index, b.index)
                if err == _NO_PEER:
                    raise RuntimeError(
                        f"{a} cannot access {b}'s memory (no peer access): "
                        "tensor parallelism on the GPUs needs peer access "
                        "between every pair of the model mesh")
                _raise_on(err, f"enabling peer access from {a} to {b}")
        self.flags = [torch.zeros(FLAG_SLOTS, dtype=torch.int64, device=g)
                      for g in self.gpus]
        self.state = [torch.zeros(4, dtype=torch.int64, device=g)
                      for g in self.gpus]
        ptr = lib.lstm_tp_host_alloc(4 * 4 * len(self.gpus))
        if not ptr:
            raise RuntimeError("the TP kernels' error record (host-mapped "
                               "memory) could not be allocated")
        self.err = (ctypes.c_int * (4 * len(self.gpus))).from_address(ptr)
        self._err_ptr = ptr
        self.streams = [torch.cuda.Stream(g) for g in self.gpus]
        self.layers: List[str] = []

    def layer_id(self, name: str) -> int:
        if name not in self.layers:
            self.layers.append(name)
        return self.layers.index(name)

    def check(self) -> None:
        """Raise the first error record a launch of this mesh left."""
        for g in range(len(self.gpus)):
            code, layer, gpu, step = self.err[4 * g:4 * g + 4]
            if code:
                name = (self.layers[layer] if 0 <= layer < len(self.layers)
                        else f"layer {layer}")
                raise RuntimeError(
                    f"the TP kernels of {name} on {self.gpus[gpu]} waited "
                    f"past their bound for a peer's step {step} (model "
                    f"mesh {[str(d) for d in self.mesh]}): a GPU of the "
                    "mesh did not run its launch")


_CONTEXTS: Dict[tuple, MeshContext] = {}


def mesh_context(mesh: Sequence[torch.device]) -> MeshContext:
    """The mesh's context, made at its first launch and kept for the
    process's life (graphs hold its buffers). One a mesh: two meshes
    never share flags."""
    key = tuple(mesh)
    if key not in _CONTEXTS:
        _CONTEXTS[key] = MeshContext(mesh)
    return _CONTEXTS[key]


def check(mesh: Optional[Sequence[torch.device]] = None) -> None:
    """Raise the error record of the mesh's launches (every mesh's
    without one). Reads host memory: the launches it sees are those that
    ended."""
    for key, ctx in list(_CONTEXTS.items()):
        if mesh is None or key == tuple(mesh):
            ctx.check()


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[t.data_ptr() if t is not None else None for t in tensors])


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * max(1, len(values)))(*values)


@contextlib.contextmanager
def _on_streams(streams):
    """Each GPU's current stream set to the given one (the forward's, in
    a backward that autograd runs on another GPU's thread)."""
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        with torch.cuda.device(streams[0].device):
            yield


def _launch_all(ctx: MeshContext, launch) -> None:
    """Launch one K8 kernel a GPU of the mesh: launch(g, stream) -> CUDA
    error. Each context stream first waits for every GPU's current stream
    (events recorded before any launch), and every current stream then
    waits for the context streams."""
    events = []
    for g in ctx.gpus:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(g))
        events.append(ev)
    for s in ctx.streams:
        for ev in events:
            s.wait_event(ev)
    for gi, (g, s) in enumerate(zip(ctx.gpus, ctx.streams)):
        with torch.cuda.device(g):
            err = launch(gi, ctypes.c_void_p(s.cuda_stream))
        if err == _TOO_LARGE:
            raise ValueError(f"the TP kernels' tiles on {g} do not all fit "
                             "the card at once (their waits would "
                             "deadlock): fewer rows, or more GPUs in the "
                             "model mesh")
        _raise_on(err, f"a TP kernel launch on {g}")
    for g, s in zip(ctx.gpus, ctx.streams):
        torch.cuda.current_stream(g).wait_stream(s)


def _check_operands(what, tensors, device):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: a shard's operand is on {t.device}, "
                             f"its shard on {device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{what}: the TP kernels take contiguous "
                            f"float32 operands, got {t.dtype}")


def _local(ctx: MeshContext, gi: int) -> List[int]:
    shards = [i for i, g in enumerate(ctx.gpu_of) if g == gi]
    if len(shards) > MAX_LOCAL:
        raise ValueError(f"{ctx.gpus[gi]} holds {len(shards)} shards of "
                         f"the model mesh: the TP kernels take at most "
                         f"{MAX_LOCAL} a GPU")
    return shards


# ------------------------------------------------------------- wrappers
def lstm_tp_fwd(mesh, acts, w_recs, peeps, masks, save: bool = False,
                name: str = "a TP layer"):
    """K8f over the model mesh `mesh` (a shard a device): (outputs, one a
    distinct device in mesh order, and with save the residuals c and
    gates a shard, else None). On CPU tensors the twin."""
    if acts[0].device.type != "cuda":
        return lstm_tp_fwd_reference(acts, w_recs, peeps, masks, mesh, save)
    from lstm_rnn_tpu_torch.ops import _build
    lib = _build.load()
    ctx = mesh_context(mesh)
    ctx.check()
    n = len(mesh)
    T, D, B, _, w = acts[0].shape
    H = n * w
    for i in range(n):
        _check_operands("lstm_tp_fwd", (acts[i], w_recs[i], peeps[i],
                                        masks[i]), mesh[i])
        if acts[i].shape != (T, D, B, 4, w):
            raise ValueError(f"shard {i}'s acts are {tuple(acts[i].shape)}, "
                             f"shard 0's {(T, D, B, 4, w)}")
    ys = [torch.empty((T, B, D * H), device=g) for g in ctx.gpus]
    cs = gs = None
    if save:
        cs = [torch.empty((T, D, B, w), device=d) for d in mesh]
        gs = [torch.empty((T, D, B, 4, w), device=d) for d in mesh]
    layer = ctx.layer_id(name)
    _launch_all(ctx, lambda gi, stream: _launch_fwd_on(
        lib, ctx, gi, _local(ctx, gi), acts, w_recs, peeps, cs, gs, masks,
        ys, layer, WAIT_BOUND_S, stream))
    lstm_tp_fwd.launches += len(ctx.gpus)
    return ys, cs, gs


def _launch_fwd_on(lib, ctx, gi, loc, acts, w_recs, peeps, cs, gs, masks,
                   ys, layer, bound_s, stream):
    """K8f on GPU gi of the mesh for its shards `loc` (indices into the
    per-shard lists; cs, gs None: no residuals): the CUDA error."""
    T, D, B, _, w = acts[loc[0]].shape
    n = len(ctx.mesh)
    save = cs is not None
    return lib.lstm_tp_fwd(
        len(loc), _ints(loc), _ptrs([acts[i] for i in loc]),
        _ptrs([w_recs[i] for i in loc]), _ptrs([peeps[i] for i in loc]),
        _ptrs([cs[i] for i in loc] if save else []),
        _ptrs([gs[i] for i in loc] if save else []),
        ctypes.c_void_p(masks[loc[0]].data_ptr()), _ptrs(ys),
        _ptrs(ctx.flags), ctypes.c_void_p(ctx.state[gi].data_ptr()),
        ctypes.c_void_p(ctx._err_ptr + 16 * gi), FLAG_SLOTS, len(ctx.gpus),
        gi, layer, ctypes.c_double(bound_s), T, B, n * w, D, w, n,
        int(save), ctx.gpus[gi].index, stream)


lstm_tp_fwd.launches = 0


def lstm_tp_bwd(mesh, gates, cs, w_recs, peeps, dys, masks,
                clip: bool = True, name: str = "a TP layer"):
    """K8b over the model mesh: da [T, D, B, 4, w] a shard. On CPU tensors
    the twin."""
    if gates[0].device.type != "cuda":
        return lstm_tp_bptt_reference(gates, cs, w_recs, peeps, dys, masks,
                                      mesh, clip)
    from lstm_rnn_tpu_torch.ops import _build
    lib = _build.load()
    ctx = mesh_context(mesh)
    ctx.check()
    n = len(mesh)
    T, D, B, _, w = gates[0].shape
    H = n * w
    # W_rec's rows of the shard's gate columns, contiguous in H
    wts = [wr.reshape(D, H, 4 * w).transpose(1, 2).contiguous()
           for wr in w_recs]
    for i in range(n):
        _check_operands("lstm_tp_bwd", (gates[i], cs[i], wts[i], peeps[i],
                                        dys[i], masks[i]), mesh[i])
    da = [torch.empty_like(g) for g in gates]
    nw = n * -(-w // TILE_CELLS)
    parts = [torch.empty((2, nw, D, B, H), device=g) for g in ctx.gpus]
    layer = ctx.layer_id(name)

    def launch(gi, stream):
        loc = _local(ctx, gi)
        return lib.lstm_tp_bwd(
            len(loc), _ints(loc), _ints(ctx.gpu_of),
            _ptrs([gates[i] for i in loc]), _ptrs([cs[i] for i in loc]),
            _ptrs([wts[i] for i in loc]), _ptrs([peeps[i] for i in loc]),
            _ptrs([dys[i] for i in loc]), _ptrs([da[i] for i in loc]),
            ctypes.c_void_p(masks[loc[0]].data_ptr()), _ptrs(parts),
            _ptrs(ctx.flags), ctypes.c_void_p(ctx.state[gi].data_ptr()),
            ctypes.c_void_p(ctx._err_ptr + 16 * gi), FLAG_SLOTS,
            len(ctx.gpus), gi, layer, ctypes.c_double(WAIT_BOUND_S), T, B, H,
            D, w, n, int(clip), ctx.gpus[gi].index, stream)

    _launch_all(ctx, launch)
    lstm_tp_bwd.launches += len(ctx.gpus)
    return da


lstm_tp_bwd.launches = 0


# ---------------------------------------------------------- the Function
@dataclasses.dataclass(frozen=True)
class TPSpec:
    """One layer's tensor-parallel launch: the model mesh (a device a
    shard), each shard's validity mask [T, D, B] on its device, the delta
    clip and the layer's name (the kernels' error record names it)."""
    mesh: tuple
    masks: tuple
    clip: bool = True
    name: str = "a TP layer"

    @property
    def gpus(self) -> list:
        return list(dict.fromkeys(self.mesh))


class LstmTPFused(torch.autograd.Function):
    """The tensor-parallel LSTM layer: inputs (spec, acts..., w_rec...,
    peep...), a shard each in mesh order; outputs the layer's output
    [T, B, D*H] on every distinct device of the mesh (mesh[0]'s first).
    Forward: K8f with the residuals; backward: each shard's cotangent
    summed over the replicas, K8b, then dW_rec and dpeep as plain
    products. d acts is K8b's da (the projection's gradients follow in
    autograd). The backward runs with every GPU's current stream set to
    the forward's (autograd runs it on one GPU's thread)."""

    @staticmethod
    def forward(ctx, spec: TPSpec, *ops):
        n = len(spec.mesh)
        acts, w_recs, peeps = ops[:n], ops[n:2 * n], ops[2 * n:]
        ys, cs, gs = lstm_tp_fwd(list(spec.mesh), acts, w_recs, peeps,
                                 spec.masks, True, spec.name)
        ctx.spec = spec
        ctx.streams = ([torch.cuda.current_stream(g) for g in spec.gpus]
                       if acts[0].device.type == "cuda" else None)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*w_recs, *peeps, *ys, *cs, *gs)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *dys):
        spec = ctx.spec
        mesh = list(spec.mesh)
        n, G = len(mesh), len(spec.gpus)
        saved = ctx.saved_tensors
        w_recs, peeps = saved[:n], saved[n:2 * n]
        ys = saved[2 * n:2 * n + G]
        cs, gs = saved[2 * n + G:3 * n + G], saved[3 * n + G:]
        streams = (_on_streams(ctx.streams) if ctx.streams
                   else contextlib.nullcontext())
        with streams:
            dy_own = _owner_cotangents(dys, mesh, gs[0].shape)
            da = lstm_tp_bwd(mesh, gs, cs, w_recs, peeps, dy_own,
                             spec.masks, spec.clip, spec.name)
            gpu_of = [spec.gpus.index(d) for d in mesh]
            grads = [tp_param_grads(ys[gpu_of[i]], da[i], cs[i])
                     for i in range(n)]
        return (None, *da, *(g[0] for g in grads), *(g[1] for g in grads))


def _owner_cotangents(dys, mesh, gshape):
    """Each shard's output cotangent [T, D, B, w] in scan order on its
    device: its cells' columns of every replica's cotangent, summed over
    the replicas in mesh order (the reduce_scatter of the replicas'
    uses, once a layer)."""
    T, D, B, _, w = gshape
    H = len(mesh) * w
    out = []
    for i, dev in enumerate(mesh):
        acc = None
        for dy in dys:
            if dy is None:
                continue
            sl = torch.stack([dy[:, :, d * H + i * w:d * H + (i + 1) * w]
                              for d in range(D)], dim=1).to(dev)
            acc = sl if acc is None else acc + sl
        if acc is None:
            acc = torch.zeros((T, D, B, w), device=dev)
        elif D == 2:
            acc = torch.stack([acc[:, 0], acc[:, 1].flip(0)], dim=1)
        out.append(acc.contiguous())
    return out
