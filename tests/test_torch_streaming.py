"""Streaming serving in the port (Network.apply_streaming,
lstm_forward_streaming, `cli --stream_chunk`) against the JAX package's, on
the same numpy inputs and weights: chunked forwards with carried (h, c)
equal the JAX package's streamed outputs and states, and the port's own
whole-sequence forward.

The port's kernel route ("auto") runs the carry kernel's twin on the CPU;
its scan route runs `_lstm_scan` with a carried state. The JAX side runs
its scan path or its carry kernel in interpret mode ("pallas_interpret"),
as tests/test_streaming.py does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu import cli as jax_cli
from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu.ops.masking import pattypes_from_lengths
from lstm_rnn_tpu_torch import cli
from lstm_rnn_tpu_torch.models.lstm import (lstm_forward,
                                            lstm_forward_streaming)
from lstm_rnn_tpu_torch.network import Network, params_from_numpy
from tests.test_cli import _assert_csv_close
from tests.test_data import _write_classification_nc
from tests.test_streaming import UNI_LAYERS

T_ALL, B = 12, 3
CHUNKINGS = [[4, 4, 4], [1, 5, 3, 3], [12]]
# f32 on both sides, products summed in another order, over 12 steps and
# two LSTM layers (the JAX package's own kernel-vs-scan bound is 2e-5)
TOL = 1e-5


def _inputs(seed=11):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (T_ALL, B, 3)).astype(np.float32)
    pt = np.asarray(pattypes_from_lengths([T_ALL, T_ALL - 2, 4], T_ALL, B))
    return x, pt


def _mid_chunk_pattypes():
    """test_streaming.py's mid-chunk case: row 0 holds sequence A (4
    frames), a 2-frame gap and sequence B (6 frames); row 1 starts
    mid-stream; row 2 is a plain prefix."""
    from lstm_rnn_tpu.ops.masking import (PATTYPE_FIRST, PATTYPE_LAST,
                                          PATTYPE_NONE, PATTYPE_NORMAL)
    pt = np.full((T_ALL, B), PATTYPE_NONE, np.int8)
    pt[:4, 0] = [PATTYPE_FIRST, PATTYPE_NORMAL, PATTYPE_NORMAL, PATTYPE_LAST]
    pt[6:, 0] = [PATTYPE_FIRST] + [PATTYPE_NORMAL] * 4 + [PATTYPE_LAST]
    pt[5:, 1] = [PATTYPE_FIRST] + [PATTYPE_NORMAL] * 5 + [PATTYPE_LAST]
    pt[:7, 2] = [PATTYPE_FIRST] + [PATTYPE_NORMAL] * 5 + [PATTYPE_LAST]
    return pt


def _jax_net(backend, seed):
    net = JaxNetwork(UNI_LAYERS, backend=backend)
    net.init_params(seed)
    return net


def _stream_jax(backend, chunks, x, pt, seed):
    net = _jax_net(backend, seed)
    params = jax.tree_util.tree_map(jnp.asarray, net.params)
    state = net.init_stream_state(x.shape[1])
    outs, lo = [], 0
    for c in chunks:
        y, state = net.apply_streaming(params, jnp.asarray(x[lo:lo + c]),
                                       jnp.asarray(pt[lo:lo + c]), state)
        outs.append(np.asarray(y))
        lo += c
    return (np.concatenate(outs),
            {k: tuple(np.asarray(a) for a in v) for k, v in state.items()})


def _stream_port(backend, chunks, x, pt, seed, state=None):
    jnet = _jax_net("scan", seed)
    net = Network(UNI_LAYERS, backend=backend)
    params = params_from_numpy(jnet.params, "cpu")
    if state is None:
        state = net.init_stream_state(x.shape[1], "cpu")
    outs, lo = [], 0
    with torch.inference_mode():
        for c in chunks:
            y, state = net.apply_streaming(
                params, torch.from_numpy(x[lo:lo + c]),
                torch.from_numpy(pt[lo:lo + c]), state)
            outs.append(y.numpy())
            lo += c
        whole = net.apply(params, torch.from_numpy(x),
                          torch.from_numpy(pt)).numpy()
    return (np.concatenate(outs),
            {k: tuple(a.numpy() for a in v) for k, v in state.items()},
            whole)


@functools.lru_cache(maxsize=None)
def _jax_streamed(backend, chunks, mid_chunk=False):
    x, pt = _inputs()
    if mid_chunk:
        pt = _mid_chunk_pattypes()
    return _stream_jax(backend, list(chunks), x, pt, 11)


def _assert_states_close(got, want):
    assert sorted(got) == sorted(want) == ["l1", "l2"]
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert g.shape == w.shape == (1, B, w.shape[-1])
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("port_backend", ["auto", "scan"])
@pytest.mark.parametrize("jax_backend", ["scan", "pallas_interpret"])
@pytest.mark.parametrize("chunks", CHUNKINGS, ids=str)
def test_apply_streaming_matches_jax(chunks, jax_backend, port_backend):
    """Outputs and carried states of the port's two routes against the JAX
    package's two streaming paths, and against the port's whole-sequence
    apply."""
    x, pt = _inputs()
    want, want_state = _jax_streamed(jax_backend, tuple(chunks))
    got, state, whole = _stream_port(port_backend, chunks, x, pt, 11)
    assert got.shape == want.shape == (T_ALL, B, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    _assert_states_close(state, want_state)
    np.testing.assert_allclose(got, whole, rtol=0, atol=TOL)


@pytest.mark.parametrize("port_backend", ["auto", "scan"])
@pytest.mark.parametrize("jax_backend", ["scan", "pallas_interpret"])
def test_mid_chunk_boundaries_match_jax(jax_backend, port_backend):
    """Chunks in which one sequence ends and another starts (NONE gaps
    inside a chunk, a row valid only from mid-stream): the state is zeroed
    at each NONE step and the next sequence starts from zero, as the JAX
    package's scan and carry kernel do. A prefix-lengths reduction fails
    this."""
    x, _ = _inputs()
    pt = _mid_chunk_pattypes()
    want, want_state = _jax_streamed(jax_backend, (4, 4, 4), True)
    got, state, whole = _stream_port(port_backend, [4, 4, 4], x, pt, 11)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    _assert_states_close(state, want_state)
    # the kernel's whole-sequence route takes prefix lengths only; the
    # scan route masks per step and equals the stream
    if port_backend == "scan":
        np.testing.assert_allclose(got, whole, rtol=0, atol=TOL)


@pytest.mark.parametrize("port_backend", ["auto", "scan"])
def test_state_resets_on_sequence_end(port_backend):
    """A NONE slot zeroes the carried state exactly, so a sequence that
    starts in a later chunk sees a fresh state, and the JAX package's state
    handed to the port carries on as the port's own."""
    rng = np.random.RandomState(7)
    xa = rng.uniform(-1, 1, (6, 1, 3)).astype(np.float32)
    pta = np.asarray(pattypes_from_lengths([4], 6, 1))
    _, state, _ = _stream_port(port_backend, [6], xa, pta, 7)
    for name, (h, c) in state.items():
        assert not h.any() and not c.any(), name

    # a mid-sequence state from the JAX package continues in the port
    x, pt = _inputs()
    _, jax_state = _stream_jax("scan", [5], x[:5], pt[:5], 11)
    handed = {k: tuple(torch.from_numpy(np.array(a)) for a in v)
              for k, v in jax_state.items()}
    got, state, _ = _stream_port(port_backend, [7], x[5:], pt[5:], 11,
                                 state=handed)
    want, want_state = _jax_streamed("scan", (5, 7))
    np.testing.assert_allclose(got, want[5:], rtol=0, atol=TOL)
    _assert_states_close(state, want_state)


def test_scan_chunk_gradients_match_whole_sequence():
    """Truncated BPTT over streamed chunks on the scan route: the chunked
    forward, differentiated by autograd with the carry flowing between
    chunks, equals the whole-sequence gradient, through a mid-run sequence
    end whose NONE gap resets the state (test_streaming.py:103's case),
    and equals the JAX package's gradient of the same chunked loss."""
    from lstm_rnn_tpu.models.lstm import \
        lstm_forward_streaming as jax_streaming
    rng = np.random.RandomState(1234)
    T, Bg, Pg, h = 12, 2, 3, 4
    params_np = {k: rng.uniform(-1, 1, s).astype(np.float32) for k, s in (
        ("W_in", (1, Pg, 4, h)), ("W_rec", (1, h, 4, h)), ("b", (1, 4, h)),
        ("peep", (1, 3, h)))}
    x_np = rng.uniform(-1, 1, (T, Bg, Pg)).astype(np.float32)
    pt_np = np.array(pattypes_from_lengths([T, 5], T, Bg))
    pt_np[8:, 1] = [1, 2, 2, 3]
    x, pt = torch.from_numpy(x_np), torch.from_numpy(pt_np)

    def leaves():
        return {k: torch.tensor(v, requires_grad=True)
                for k, v in params_np.items()}

    pw = leaves()
    whole = (lstm_forward(pw, x, pt, 1.0, False, backend="scan") ** 2).sum()
    whole.backward()
    pc = leaves()
    state = (torch.zeros(1, Bg, h), torch.zeros(1, Bg, h))
    total, off = 0.0, 0
    for n in [5, 4, 3]:
        y, state = lstm_forward_streaming(pc, x[off:off + n],
                                          pt[off:off + n], 1.0, state,
                                          backend="scan")
        total = total + (y ** 2).sum()
        off += n
    total.backward()
    np.testing.assert_allclose(total.item(), whole.item(), rtol=1e-6)

    def jax_chunked(p):
        st = (jnp.zeros((1, Bg, h)), jnp.zeros((1, Bg, h)))
        tot, o = 0.0, 0
        for n in [5, 4, 3]:
            yy, st = jax_streaming(p, jnp.asarray(x_np[o:o + n]),
                                   jnp.asarray(pt_np[o:o + n]), 1.0, st,
                                   backend="scan")
            tot = tot + jnp.sum(yy ** 2)
            o += n
        return tot
    g_jax = jax.grad(jax_chunked)({k: jnp.asarray(v)
                                   for k, v in params_np.items()})
    for k in params_np:
        scale = float(np.abs(pw[k].grad.numpy()).max())
        np.testing.assert_allclose(pc[k].grad.numpy(), pw[k].grad.numpy(),
                                   rtol=0, atol=2e-5 * scale, err_msg=k)
        np.testing.assert_allclose(pc[k].grad.numpy(), np.asarray(g_jax[k]),
                                   rtol=0, atol=2e-5 * scale, err_msg=k)


def test_kernel_route_is_inference_only():
    """The carry kernel has no backward: a streamed chunk on the kernel
    route under autograd raises, as the JAX package's masked carry kernel
    does; the scan route is the differentiable one."""
    net = Network(UNI_LAYERS)
    net.init_params(3)
    params = net.device_params("cpu")
    for layer in params.values():
        for v in layer.values():
            v.requires_grad_(True)
    x, pt = _inputs()
    with pytest.raises(NotImplementedError, match="inference-only"):
        net.apply_streaming(params, torch.from_numpy(x[:4]),
                            torch.from_numpy(pt[:4]),
                            net.init_stream_state(B, "cpu"))


def test_init_stream_state_rejects_blstm():
    layers = [dict(lay) for lay in UNI_LAYERS]
    layers[3]["type"] = "blstm"
    net = Network(layers)
    with pytest.raises(ValueError, match="'l2' is bidirectional"):
        net.init_stream_state(2, "cpu")
    params = {"W_in": torch.zeros(2, 3, 4, 2), "W_rec": torch.zeros(2, 2, 4, 2),
              "b": torch.zeros(2, 4, 2), "peep": torch.zeros(2, 3, 2)}
    with pytest.raises(ValueError, match="bidirectional"):
        lstm_forward_streaming(params, torch.zeros(4, 1, 3),
                               torch.ones(4, 1), 1.0, None)


def test_init_stream_state_is_zero_f32_per_lstm_layer():
    net = Network(UNI_LAYERS)
    state = net.init_stream_state(5, "cpu")
    assert sorted(state) == ["l1", "l2"]
    for (h, c), size in zip((state["l1"], state["l2"]), (5, 4)):
        assert h.shape == c.shape == (1, 5, size)
        assert h.dtype == torch.float32 and not h.any() and not c.any()


def _cli_setup(tmp_path):
    """A unidirectional net (the streaming stack's shape, narrow) and
    sequences of 6, 5, 1, 7 and 3 frames in 2 fractions of 3 rows."""
    import json
    nc = str(tmp_path / "ff.nc")
    _write_classification_nc(nc, [6, 5, 1, 7, 3], in_size=3, num_labels=4,
                             seed=5)
    net_path = str(tmp_path / "uni.jsn")
    with open(net_path, "w") as f:
        json.dump({"layers": UNI_LAYERS}, f)
    return ["--network", net_path, "--train", "false", "--ff_input_file", nc,
            "--parallel_sequences", "3", "--random_seed", "17",
            "--ff_output_format", "single_csv", "--device", "cpu"]


@pytest.mark.parametrize("backend", ["auto", "scan"])
def test_cli_stream_chunk_matches_jax(tmp_path, capsys, backend):
    """`--stream_chunk 3` (chunks of 3 frames, the last of a fraction
    shorter) writes the JAX CLI's streamed posteriors, and the port's own
    whole-sequence dump."""
    common = _cli_setup(tmp_path)
    assert jax_cli.main(common + ["--stream_chunk", "3", "--ff_output_file",
                                  str(tmp_path / "jax.csv")]) == 0
    capsys.readouterr()
    port = common + ["--lstm_backend", backend]
    assert cli.main(port + ["--stream_chunk", "3", "--ff_output_file",
                            str(tmp_path / "port.csv")]) == 0
    assert ("Streaming forward: 3-frame chunks, carried LSTM state"
            in capsys.readouterr().out)
    assert cli.main(port + ["--ff_output_file",
                            str(tmp_path / "whole.csv")]) == 0
    _assert_csv_close(tmp_path / "port.csv", tmp_path / "jax.csv")
    _assert_csv_close(tmp_path / "port.csv", tmp_path / "whole.csv")
