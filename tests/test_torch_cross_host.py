"""A seq or pipe mesh over several processes in the port (parallel/
launch.py's spanning plan, parallel/mesh.py `SpanMesh`, parallel/hop.py,
the span paths of parallel/sequence.py and parallel/pipeline.py, and the
CLI's multi-host flags with --seq_devices or --pipeline_devices k, k the
global device count) on the CPU: gloo between processes, each holding
one or two positions of the mesh (the CPU named once or twice).

The port's runs are held against the JAX package's on the same inputs:
its `loss_and_count_seq` and `loss_and_count_pipelined` on forced host
devices (conftest gives this process 8), and its CLI as two processes of
one or two forced devices each, as tests/test_distributed.py launches
it. Bounds: a step's error, count and gradients against the port's own
one-process step within 1e-6 of the largest entry (tests/
test_torch_dp_sp.py's STEP_TOL: only the order of the f32 sums over the
processes differs), against JAX's within the bounds tests/
test_torch_sequence.py and tests/test_torch_pipeline.py hold the port's
one-process SP and PP to; trained weights within the JAX tests' rtol
1e-5, atol 1e-7 (tests/test_distributed.py:104-110).

Every multi-process run is a subprocess of its own with its own time
limit, killed with its workers when the limit passes, so that a hang
fails its test well inside the process group's 600 s timeout. This module
imports no JAX package at its top: a spawned worker imports it to find
the functions it runs.
"""

import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from lstm_rnn_tpu_torch.parallel import hop, launch
from tests.test_torch_data_parallel import (_assert_weights_close, _env,
                                            _free_port)

CPU = torch.device("cpu")
# a CLI or step run's limit: seconds here, a hang fails the test
RUN_TIMEOUT = 240
STEP_TOL = 1e-6
# the port's one-process SP and PP against JAX's (tests/
# test_torch_sequence.py ROUTES["kernel"], tests/test_torch_pipeline.py):
# loss rtol, gradient rtol and atol
JAX_SEQ_TOL = (2e-5, 5e-4, 5e-4)
JAX_PIPE_TOL = (1e-6, 2e-5, 1e-6)
RUNNER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_span_runner.py")

# tests/test_sequence.py's net (a BLSTM, a feedforward layer, an LSTM);
# its unidirectional twin; a regression net for the unfused tail
NETS = {
    "bi": [
        {"name": "input", "type": "input", "size": 3},
        {"name": "b1", "type": "blstm", "size": 4, "bias": 1.0},
        {"name": "ff", "type": "feedforward_tanh", "size": 6, "bias": 0.5},
        {"name": "l2", "type": "lstm", "size": 5, "bias": 1.0},
        {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
        {"name": "post", "type": "multiclass_classification", "size": 4}],
    "uni": [
        {"name": "input", "type": "input", "size": 3},
        {"name": "l1", "type": "lstm", "size": 4, "bias": 1.0},
        {"name": "l2", "type": "lstm", "size": 3, "bias": 1.0},
        {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
        {"name": "post", "type": "multiclass_classification", "size": 4}],
    "sse": [
        {"name": "input", "type": "input", "size": 3},
        {"name": "b1", "type": "blstm", "size": 4, "bias": 1.0},
        {"name": "l2", "type": "lstm", "size": 3, "bias": 1.0},
        {"name": "output", "type": "feedforward_identity", "size": 2,
         "bias": 1.0},
        {"name": "post", "type": "sse", "size": 2}],
}
# (kind, net, microbatches) of the steps, by layout (positions a process)
STEPS = {
    (1, 1): [("seq", "bi", 0), ("seq", "uni", 0), ("pipe", "bi", 2),
             ("pipe", "bi", 3), ("pipe", "sse", 2), ("pipe", "sse", 3)],
    (1, 2): [("seq", "bi", 0), ("seq", "uni", 0)],
}


def _batch(net):
    """Five rows of T = 7 (padded to 8 or 9 for 2 or 3 blocks), lengths 7,
    3, 6, 1 and 0: the rows of 1 and 3 frames end inside the first block,
    the last is empty; B = 5 pads to 6 over 2 or 3 microbatches."""
    rng = np.random.RandomState(21)
    T, b = 7, 5
    lengths = np.array([7, 3, 6, 1, 0])
    pt = (np.arange(T)[:, None] < lengths[None, :]).astype(np.int8)
    if net == "sse":
        tg = rng.uniform(-1, 1, (T, b, 2)).astype(np.float32)
        tg[pt == 0] = 0
    else:
        tg = np.where(pt > 0, rng.randint(0, 4, (T, b)), -1).astype(np.int32)
    return rng.uniform(-1, 1, (T, b, 3)).astype(np.float32), tg, pt


def _params(net):
    """The JAX package's initial weights of the net (seed 11), numpy."""
    from lstm_rnn_tpu.network import Network as JaxNetwork
    jnet = JaxNetwork(NETS[net])
    jnet.init_params(11)
    return jnet.params


def _port_net(net, params):
    from lstm_rnn_tpu_torch.network import Network
    pnet = Network(NETS[net])
    pnet.params = params
    return pnet


def _step(pnet, mesh, kind, m, batch):
    """(error, count, gradients as numpy, by leaf in sorted order) of one
    step of the port on `mesh` (a device list or a SpanMesh)."""
    from lstm_rnn_tpu_torch.parallel.pipeline import \
        loss_and_count_pipelined
    from lstm_rnn_tpu_torch.parallel.sequence import loss_and_count_seq
    params = pnet.device_params("cpu")
    names = [(n, k) for n in sorted(params) for k in sorted(params[n])]
    leaves = [params[n][k].requires_grad_(True) for n, k in names]
    x, tg, pt = map(torch.from_numpy, batch)
    if kind == "seq":
        err, corr = loss_and_count_seq(pnet, params, x, tg, pt, mesh)
    else:
        err, corr = loss_and_count_pipelined(pnet, params, x, tg, pt, mesh,
                                             m)
    grads = torch.autograd.grad(err, leaves, allow_unused=True)
    return err.item(), int(corr), {
        f"{n}/{k}": (np.zeros(v.shape, np.float32) if g is None
                     else g.numpy()) for (n, k), g, v in
        zip(names, grads, leaves)}


# ----------------------------------------------------- workers (spawned)
def _count_calls(names):
    """Wrap ops/lstm_cell.py's wrappers `names` to count their calls (on
    the CPU their twins run: no launch counts)."""
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    calls = dict.fromkeys(names, 0)
    for name in names:
        def wrapped(*a, _f=getattr(lc, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        setattr(lc, name, wrapped)
    return calls


def _steps_worker(group, out_dir, layout):
    """Every step of STEPS[layout] on this rank's positions of the span:
    its error, count, gradients, hops and wrapper calls."""
    calls = _count_calls(["lstm_fwd_save_carry", "lstm_bwd_carry",
                          "lstm_fwd_save", "lstm_bwd"])
    out = {}
    for kind, net, m in STEPS[layout]:
        params = torch.load(os.path.join(out_dir, f"{net}.pt"),
                            weights_only=False)
        batch = torch.load(os.path.join(out_dir, f"{net}_batch.pt"),
                           weights_only=False)
        hop.reset_counts()
        for k in calls:
            calls[k] = 0
        res = _step(_port_net(net, params), group.span, kind, m, batch)
        out[(kind, net, m)] = res + (dict(hop.COUNTS), dict(calls))
    if layout == (1, 1):
        out.update(_span_trainer_runs(group, out_dir))
    torch.save(out, os.path.join(out_dir, f"rank{group.rank}.pt"))


def _span_trainer_runs(group, out_dir):
    """The Trainer on the span as a seq and as a pipe mesh (the "bi" net,
    2 epochs over out_dir/train.nc, the device cache on) with fuse 1 and
    fuse 4: {("trainer", axis, fuse): its rows, parameters, stacked
    entries and the lines it printed}."""
    import contextlib
    import io

    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.trainer import Trainer
    from tests.torch_fused_worker import train_rows
    out = {}
    for axis in ("seq", "pipe"):
        for fuse in (1, 4):
            # a fresh copy: the CPU Trainer trains the arrays it is given
            params = torch.load(os.path.join(out_dir, "bi.pt"),
                                weights_only=False)
            ds = DataSet([os.path.join(out_dir, "train.nc")],
                         parallel_sequences=3, sort_by_length=True,
                         prefetch=False, fraction_shuffling=True, seed=11,
                         bucket_lengths=True)
            t = Trainer(_port_net("bi", params), ds, learning_rate=1e-3,
                        momentum=0.9, max_epochs=2, hybrid_online_batch=True,
                        device="cpu", data_group=group, fuse_fractions=fuse,
                        device_cache=True, **{f"{axis}_mesh": group.span})
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rows, weights = train_rows(t)
            out[("trainer", axis, fuse)] = {
                "rows": rows, "params": weights, "stacked": len(t._stacked),
                "out": buf.getvalue()}
    return out


def _launch(fn, layout, out_dir, *args):
    """In a subprocess: launch.start(fn) over workers holding `layout`
    positions each (the CPU that many times) of one span."""
    launch.start(fn, [[CPU] * n for n in layout], (out_dir,) + tuple(args),
                 span=True)


def _start_launch(fn_name, layout, out_dir, *args):
    """_launch(fn_name) in a subprocess of its own (its workers are its
    children), started and not waited for."""
    code = ("import sys, tests.test_torch_cross_host as t; "
            f"t._launch(t.{fn_name}, {tuple(layout)!r}, sys.argv[1], "
            f"*{tuple(args)!r})")
    return subprocess.Popen(
        [sys.executable, "-c", code, str(out_dir)], cwd=str(out_dir),
        env=_env(), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, start_new_session=True)


def _join(procs, what):
    """Wait for every process (each a process group of its own) for at
    most RUN_TIMEOUT, then kill whatever is left; their outputs, each
    checked for rc 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RUN_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{what} did not end within {RUN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _hop_worker(group, out_dir, zero_cotangents):
    """A chain over two processes: position 0 (rank 0) computes v0 and
    hands it up, position 1 (rank 1) computes v1 from it and hands it back
    down, and rank 0 ends with (v1 W2)^2 while rank 1 adds sum(v1). Saves
    each rank's loss, gradients and hop counts. The control's backward
    sends zero cotangents."""
    if zero_cotangents:
        def zeros_back(ctx, g_token, g_y):
            peer, bwd = ctx.meta
            hop._send(torch.zeros_like(g_y), peer, bwd)
            return g_token, None, None, None, None, None, None
        hop._Recv.backward = staticmethod(zeros_back)
    x, ws = _chain_inputs()
    ws = [w.requires_grad_(True) for w in ws]
    hop.reset_counts()
    chain = hop.Chain(group.span, hop.anchor(ws, CPU))
    if group.rank == 0:
        chain.send(torch.tanh(x @ ws[0]), 0, 1)
        v1 = chain.recv(1, 0, (3, 4), torch.float32)
        loss = (v1 @ ws[2]).pow(2).sum()
    else:
        v0 = chain.recv(0, 1, (3, 4), torch.float32)
        v1 = torch.tanh(v0 @ ws[1])
        chain.send(v1, 1, 0)
        loss = v1.sum()
    err = chain.close(loss)
    grads = torch.autograd.grad(err, ws, allow_unused=True)
    torch.save({"loss": loss.detach(), "err": err.detach(),
                "grads": [None if g is None else g for g in grads],
                "counts": dict(hop.COUNTS)},
               os.path.join(out_dir, f"rank{group.rank}.pt"))


def _chain_inputs():
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 4, generator=g)
    return x, [torch.randn(4, 4, generator=g) for _ in range(3)]


# ------------------------------------------------------------- the plans
def _plan(monkeypatch, argv, n, pid=0, hosts=2, train=True):
    from lstm_rnn_tpu_torch.config import parse_config
    monkeypatch.setattr(launch, "local_devices",
                        lambda device_type, k=1: [CPU] * n)
    cfg = parse_config(["--network", "n.jsn", "--device", "cpu",
                        "--train", "true" if train else "false",
                        "--coordinator_address", "h:1", "--num_processes",
                        str(hosts), "--process_id", str(pid)] + argv)
    return launch.plan(cfg, CPU)


@pytest.mark.parametrize("flag, k, sizes", [
    ("--seq_devices", 2, (1, 1)), ("--seq_devices", 4, (2, 2)),
    ("--seq_devices", 3, (1, 2)), ("--pipeline_devices", 2, (1, 1))],
    ids=["sp_2x1", "sp_2x2", "sp_1+2", "pp_2x1"])
def test_plan_of_a_spanning_group(monkeypatch, flag, k, sizes):
    """k equal to the hosts' devices in all: each process starts one
    worker, which holds its devices as its part of the one mesh."""
    axis = "seq" if flag == "--seq_devices" else "pipe"
    for pid, n in enumerate(sizes):
        p = _plan(monkeypatch, [flag, str(k)], n, pid, len(sizes))
        assert p.span == k and p.axis == axis and p.process_id == pid
        assert p.devices == (CPU,) and p.meshes == ((CPU,) * n,)
        assert p.world == len(sizes) and p.local_count == n


@pytest.mark.parametrize("argv, n, hosts, match", [
    (["--seq_devices", "2"], 3, 2,
     "seq group across hosts inside a composed .*mesh.py:132.*ROADMAP"),
    (["--seq_devices", "2"], 1, 4,
     "seq group across hosts inside a composed .*mesh.py:132.*ROADMAP"),
    (["--pipeline_devices", "2"], 3, 2,
     "pipe group across hosts inside a composed .*mesh.py:132.*ROADMAP"),
    (["--model_devices", "2"], 1, 2,
     "model group across hosts: tensor parallelism across hosts.*"
     "mesh.py:132.*ROADMAP"),
], ids=["sp_2x3", "sp_4x1", "pp_2x3", "tp_2x1"])
def test_plan_refuses_what_jax_cannot_train(monkeypatch, argv, n, hosts,
                                            match):
    """A composed group whose row crosses a host and TP across hosts are
    refused by name before any worker starts: the JAX package fails there
    too ('Invalid host data')."""
    with pytest.raises(ValueError, match=match):
        _plan(monkeypatch, argv, n, 0, hosts)


def _rendezvous(plans):
    """_serve_store on every plan at once (a thread a process): each
    process's counts or error."""
    res = {}

    def host(i, p):
        try:
            res[i] = launch._serve_store(p)[2]
        except RuntimeError as e:
            res[i] = str(e)
    threads = [threading.Thread(target=host, args=(i, p))
               for i, p in enumerate(plans)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return res


@pytest.mark.parametrize("sizes, k, ok", [
    ((1, 2), 3, True), ((2, 2), 4, True), ((1, 1), 3, False),
    ((1, 2), 0, False)], ids=["span_1+2", "span_2x2", "span_short",
                              "dp_unequal"])
def test_rendezvous_checks_the_span(sizes, k, ok):
    """Under a span the hosts' counts may differ but must add up to k, and
    every process learns them all; hosts of unequal size stay refused for
    every other run (here DP)."""
    addr = ("127.0.0.1", _free_port())
    plans = [launch.Plan((CPU,) if k else (CPU,) * n, hosts=len(sizes),
                         process_id=i, addr=addr,
                         meshes=((CPU,) * n,) if k else None, span=k)
             for i, n in enumerate(sizes)]
    res = _rendezvous(plans)
    assert sorted(res) == list(range(len(sizes)))
    for got in res.values():
        if ok:
            assert got == list(sizes)
        elif k:
            assert "must span every host's devices" in got
            assert "process 1 on" in got and "has 1" in got
        else:
            assert "same number of devices" in got


# -------------------------------------------------------------- the hop
@pytest.fixture(scope="module")
def hop_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hop")
    res = {}
    dirs = {control: root / ("zeros" if control else "hop")
            for control in (False, True)}
    procs = []
    for control, d in dirs.items():
        d.mkdir()
        procs.append(_start_launch("_hop_worker", (1, 1), d, control))
    _join(procs, "the hop's chain")
    for control, d in dirs.items():
        res[control] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                        for r in range(2)]
    return res


def test_hop_chain_matches_one_process(hop_runs):
    """A chain through the hop, up and back down, over two gloo
    processes: each rank's loss and every gradient equal the one-process
    chain's bit for bit, and each side counts one message each way in
    the forward and one cotangent each way in the backward. The control,
    whose backward sends zero cotangents, must fail."""
    x, ws = _chain_inputs()
    ws = [w.requires_grad_(True) for w in ws]
    v1 = torch.tanh(torch.tanh(x @ ws[0]) @ ws[1])
    losses = [(v1 @ ws[2]).pow(2).sum(), v1.sum()]
    want = torch.autograd.grad(losses[0] + losses[1], ws)

    def grads(runs):
        return [sum(r["grads"][j] for r in runs if r["grads"][j] is not None)
                for j in range(3)]

    runs = hop_runs[False]
    for r, loss in zip(runs, losses):
        assert torch.equal(r["loss"], loss.detach())
        assert torch.equal(r["err"], loss.detach())
        assert r["counts"] == {"send": 1, "recv": 1, "send_grad": 1,
                               "recv_grad": 1}
    for g, w in zip(grads(runs), want):
        assert torch.equal(g, w)
    bad = grads(hop_runs[True])
    assert not torch.equal(bad[0], want[0])
    assert torch.equal(bad[2], want[2])  # rank 0's own weight stays right


# ------------------------------------------------------------ the steps
_STEPS = {}


def _span_steps(layout, root):
    """Each rank's results of STEPS[layout]. The first call launches every
    layout's steps at once, a subprocess each, and the results are kept
    for the module."""
    if not _STEPS:
        procs = []
        for lay in STEPS:
            d = root / f"steps_{'_'.join(map(str, lay))}"
            d.mkdir()
            for net in {net for _, net, _ in STEPS[lay]}:
                torch.save(_params(net), d / f"{net}.pt")
                torch.save(_batch(net), d / f"{net}_batch.pt")
            if lay == (1, 1):
                from tests.test_data import _write_classification_nc
                _write_classification_nc(str(d / "train.nc"),
                                         [8, 5, 8, 4, 7, 8, 6, 8],
                                         in_size=3, num_labels=4, seed=3)
            procs.append((lay, d, _start_launch("_steps_worker", lay, d,
                                                lay)))
        _join([p for _, _, p in procs], "the span steps")
        for lay, d, _ in procs:
            _STEPS[lay] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                           for r in range(len(lay))]
    return _STEPS[layout]


@pytest.fixture(scope="module")
def steps_root(tmp_path_factory):
    return tmp_path_factory.mktemp("steps")


def _jax_step(kind, net, k, m):
    import jax
    import jax.numpy as jnp
    from lstm_rnn_tpu.network import Network as JaxNetwork
    from lstm_rnn_tpu.parallel import pipeline as jax_pp
    from lstm_rnn_tpu.parallel import sequence as jax_sp
    from lstm_rnn_tpu.parallel.mesh import make_mesh
    jnet = JaxNetwork(NETS[net], backend="scan")
    jnet.params = _params(net)
    params = jax.tree_util.tree_map(jnp.asarray, jnet.params)
    x, tg, pt = map(jnp.asarray, _batch(net))
    mesh = make_mesh(k, axis=kind)

    def loss(p):
        if kind == "seq":
            return jax_sp.loss_and_count_seq(jnet, p, x, tg, pt, mesh)
        return jax_pp.loss_and_count_pipelined(jnet, p, x, tg, pt, mesh,
                                               microbatches=m)
    (err, corr), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return float(err), int(corr), {f"{n}/{key}": np.asarray(g[n][key])
                                   for n in g for key in g[n]}


def _rel(got, want):
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / max(
        float(np.abs(want[k]).max()) for k in want)


@pytest.mark.parametrize("layout, case", [
    (layout, case) for layout, cases in STEPS.items() for case in cases],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v[0], int) else
    f"{v[0]}_{v[1]}" + (f"_m{v[2]}" if v[2] else ""))
def test_span_step_matches_one_process_and_jax(steps_root, layout, case):
    """One SP or PP step over processes holding `layout` positions (one
    and one, one and two): the ranks' errors and counts add up to the
    port's one-process step on the same mesh size and to JAX's, and so do
    their gradients; each rank counts its exact hops and wrapper calls."""
    from lstm_rnn_tpu_torch.parallel.mesh import make_seq_mesh
    kind, net, m = case
    k = sum(layout)
    params = _params(net)
    runs = [r[case] for r in _span_steps(layout, steps_root)]
    err = sum(r[0] for r in runs)
    corr = sum(r[1] for r in runs)
    grads = {key: sum(r[2][key] for r in runs) for key in runs[0][2]}
    e1, c1, g1 = _step(_port_net(net, params), make_seq_mesh(k, "cpu"),
                       kind, m, _batch(net))
    assert abs(err - e1) <= STEP_TOL * abs(e1) and corr == c1
    assert _rel(grads, g1) <= STEP_TOL
    ej, cj, gj = _jax_step(kind, net, k, m)
    loss_rtol, grad_rtol, grad_atol = (JAX_SEQ_TOL if kind == "seq"
                                       else JAX_PIPE_TOL)
    np.testing.assert_allclose(err, ej, rtol=loss_rtol)
    assert corr == cj
    for key in gj:
        np.testing.assert_allclose(grads[key], gj[key], rtol=grad_rtol,
                                   atol=grad_atol, err_msg=key)
    _check_counts(kind, net, m, layout, runs)


@pytest.mark.parametrize("axis", ["seq", "pipe"])
def test_span_trainer_fuses_bit_for_bit(steps_root, axis):
    """The Trainer on a seq or pipe mesh over two processes (a CPU
    position each, gloo: no hop is staged through host memory) with fuse
    4 and the device cache: the stacked epoch on both ranks, no note, and
    every rank's epochs and weights bit for bit its fuse-1 run."""
    for run in _span_steps((1, 1), steps_root):
        one, fused = run[("trainer", axis, 1)], run[("trainer", axis, 4)]
        assert fused["rows"] == one["rows"]
        for n in one["params"]:
            for k in one["params"][n]:
                np.testing.assert_array_equal(fused["params"][n][k],
                                              one["params"][n][k])
        assert fused["stacked"] == 1 and one["stacked"] == 0
        assert "one fraction at a time" not in fused["out"]


@pytest.mark.parametrize("backend, device, fuse", [
    ("gloo", "cuda:0", 1), ("nccl", "cuda:0", 8), ("gloo", "cpu", 8)])
def test_span_fuse_gate(monkeypatch, capsys, backend, device, fuse):
    """The fuse gate on a mesh across processes: a hop over gloo with
    CUDA tensors (two processes on one card: every message staged
    through host memory, which no step graph captures) keeps one
    fraction at a time and says so once, in the words the Trainer has
    used since before the span fused; over NCCL, and over gloo on the
    CPU, the pass fuses."""
    import types

    import torch.distributed as dist

    from lstm_rnn_tpu_torch.trainer import Trainer
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    t = types.SimpleNamespace(
        fuse_fractions=8, hybrid_online_batch=True, weight_noise_sigma=0.0,
        span=types.SimpleNamespace(groups={"up": object(),
                                           "down": object()}),
        device=torch.device(device), _notes=set())
    t._note = lambda msg: Trainer._note(t, msg)
    assert Trainer._fuse(t, True) == fuse
    assert Trainer._fuse(t, False) == fuse
    out = capsys.readouterr().out
    note = ("fuse_fractions=8: no step graph holds a seq or pipe mesh that "
            "spans processes; every pass steps one fraction at a time (the "
            "same values)")
    assert out.count(note) == (1 if fuse == 1 else 0)


def _check_counts(kind, net, m, layout, runs):
    """Hops: SP sends each layer's carry (h and c in one message) once a
    direction across each process boundary it crosses, and the backward
    its cotangent once; PP one message a microbatch across the one stage
    boundary. Calls: SP runs the carry pair once a block and direction;
    PP's stages their forward with residuals twice a microbatch (the
    checkpoint's recompute) and the BPTT once."""
    layers = [s for s in NETS[net][1:-1] if s["type"] in ("lstm", "blstm")]
    dirs = sum(2 if s["type"] == "blstm" else 1 for s in layers)
    n_proc = len(layout)
    for r, run in enumerate(runs):
        hops, calls = run[3], run[4]
        if kind == "seq":
            # direction 0 crosses up from every process but the last,
            # direction 1 down from every process but the first
            ups = len(layers) * (r < n_proc - 1)
            downs = (dirs - len(layers)) * (r > 0)
            into = len(layers) * (r > 0) + (dirs - len(layers)) * (
                r < n_proc - 1)
            assert hops == {"send": ups + downs, "recv": into,
                            "send_grad": into, "recv_grad": ups + downs}
            blocks = layout[r]
            assert calls == {"lstm_fwd_save_carry": dirs * blocks,
                             "lstm_bwd_carry": dirs * blocks,
                             "lstm_fwd_save": 0, "lstm_bwd": 0}
        else:
            from lstm_rnn_tpu_torch.parallel.pipeline import stage_ranges
            lo, hi = stage_ranges(len(NETS[net]) - 2, 2)[r]
            mine = [s for s in NETS[net][1 + lo:1 + hi]
                    if s["type"] in ("lstm", "blstm")]
            assert hops == ({"send": m, "recv": 0, "send_grad": 0,
                             "recv_grad": m} if r == 0 else
                            {"send": 0, "recv": m, "send_grad": m,
                             "recv_grad": 0})
            assert calls == {"lstm_fwd_save_carry": 0, "lstm_bwd_carry": 0,
                             "lstm_fwd_save": 2 * m * len(mine),
                             "lstm_bwd": m * len(mine)}


# -------------------------------------------------------------- the CLI
# 2 x BLSTM(4) on tests/test_distributed.py's corpus and flags: 2 hidden
# LSTM layers and the softmax, so that 2 pipeline stages have work
CLI_NET = [
    {"name": "input", "type": "input", "size": 3},
    {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
    {"name": "l2", "type": "blstm", "size": 4, "bias": 1.0},
    {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": 4}]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tests.test_data import _write_classification_nc
    d = tmp_path_factory.mktemp("cross_host")
    _write_classification_nc(str(d / "train.nc"), [6, 5, 4, 7, 8, 3],
                             in_size=3, num_labels=4, seed=7)
    (d / "net.jsn").write_text(json.dumps({"layers": CLI_NET}))
    return d


def _train_args(c, *extra):
    """tests/test_distributed.py:57-66."""
    return ["--network", str(c / "net.jsn"), "--train", "true",
            "--train_file", str(c / "train.nc"), "--stochastic", "true",
            "--learning_rate", "1e-3", "--parallel_sequences", "4",
            "--random_seed", "5", "--max_epochs", "2", "--device", "cpu",
            "--fuse_fractions", "4", "--bucket_lengths", "true", *extra]


def _start_hosts(cmds, dirs, envs):
    """One process a host (cmds[i] in dirs[i] with envs[i]) joined by the
    multi-host flags, started and not waited for."""
    port = _free_port()
    procs = []
    for i, (cmd, d, env) in enumerate(zip(cmds, dirs, envs)):
        os.makedirs(d, exist_ok=True)
        procs.append(subprocess.Popen(
            cmd + ["--coordinator_address", f"127.0.0.1:{port}",
                   "--num_processes", str(len(cmds)), "--process_id",
                   str(i)], cwd=str(d), env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True))
    return procs


_CLI = {}


def _cli_runs(corpus, root, flag, sizes):
    """The port's CLI and the JAX CLI as len(sizes) processes, process i
    with sizes[i] devices, training with `flag` k = sum(sizes): (the
    port's outputs and directories, the JAX run's directories)."""
    key = (flag, sizes)
    if key not in _CLI:
        from tests.test_distributed import _cli_env
        name = f"{flag.strip('-')}_{'_'.join(map(str, sizes))}"
        args = _train_args(corpus, flag, str(sum(sizes)))
        port_dirs = [root / f"{name}_port{i}" for i in range(len(sizes))]
        jax_dirs = [root / f"{name}_jax{i}" for i in range(len(sizes))]
        # the two jobs at once, each on its own coordinator port
        procs = _start_hosts([[sys.executable, RUNNER, str(n)] + args
                              for n in sizes], port_dirs,
                             [_env()] * len(sizes))
        procs += _start_hosts(
            [[sys.executable, "-m", "lstm_rnn_tpu.cli"] + args] * len(sizes),
            jax_dirs, [_cli_env(n) for n in sizes])
        outs = _join(procs, f"the CLI runs of {flag} over {sizes}")
        _CLI[key] = (outs[:len(sizes)], port_dirs, jax_dirs)
    return _CLI[key]


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    return tmp_path_factory.mktemp("cross_host_cli")


@pytest.mark.parametrize("flag, sizes, banner", [
    ("--seq_devices", (1, 1),
     "Sequence-parallel mesh: {'seq': 2} (time axis sharded)"),
    ("--pipeline_devices", (1, 1),
     "Pipeline mesh: {'pipe': 2} (3 hidden layers over 2 stages)"),
    ("--seq_devices", (1, 2),
     "Sequence-parallel mesh: {'seq': 3} (time axis sharded)"),
], ids=["sp_2x1", "pp_2x1", "sp_1+2"])
def test_cli_matches_jax_two_process_run(corpus, cli_root, flag, sizes,
                                         banner):
    """The port's CLI as two processes (one CPU device each, or one and
    two) training a seq or pipe mesh over all of them, against the JAX
    CLI's two processes with the same flags and forced devices: the
    trained weights, the JAX banner on process 0, and process 1 silent
    and writing nothing."""
    outs, port_dirs, jax_dirs = _cli_runs(corpus, cli_root, flag, sizes)
    assert banner in outs[0]
    assert "mesh" not in outs[1] and "Starting training" not in outs[1]
    assert os.listdir(port_dirs[1]) == []
    _assert_weights_close(port_dirs[0] / "trained_network.jsn",
                          jax_dirs[0] / "trained_network.jsn")


def test_cli_span_needs_every_hosts_devices(corpus, tmp_path):
    """Two processes of one CPU device each asking for --seq_devices 3: the
    rendezvous refuses the span (2 devices in all) on both processes,
    naming each host, before any work."""
    procs = _start_hosts([[sys.executable, RUNNER, "1", *_train_args(
        corpus, "--seq_devices", "3")]] * 2, [tmp_path] * 2, [_env()] * 2)
    outs = []
    try:
        outs = [p.communicate(timeout=RUN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 2, out[-2000:]
        assert "must span every host's devices" in out
    assert "Starting training" not in outs[0]
    assert not os.path.exists(tmp_path / "trained_network.jsn")
