"""CURRENNT JSON network/checkpoint format interop.

The reference's network file doubles as its checkpoint format: a JSON object
with a "layers" array ({name, type, size[, bias][, learningRate]}) and a
"weights" object mapping layer name -> {"input": [...], "bias": [...],
"internal": [...]} flat float arrays (TrainableLayer.cu:212-248,
NeuralNetwork.cpp:193-235). Reference-trained networks must load bit-for-bit
and our exports must be loadable by the reference toolkit and its ecosystem
of JSON-surgery scripts (sandbox/*.pl, scripts/discriminative_pretraining.pl).

Flat layouts (LstmLayer.hpp:36-55, LstmLayer.cu:535-597), with
P = preceding layer size, L = layer size, D = directions (blstm: 2),
H = L/D cells per direction, gate order [ni, ig, fg, og]:

- feedforward/softmax "input": column-major (rows=P, cols=L) matrix, i.e.
  flat[l*P + p] = W[p, l]; "bias": [L]; "internal": empty.
- lstm/blstm "input": 4 gate blocks of L*P each; within a gate block the
  forward-direction half comes first (H columns of length P), then the
  backward half: flat[g*L*P + d*H*P + j*P + p] = W_in[d, p, g, j].
- "bias": 4 gate blocks of L: flat[g*L + d*H + j] = b[d, g, j].
- "internal" = recurrent weights then peepholes:
  recurrent: 4 gate blocks of L*H; per gate fw half then bw half,
  column-major (rows=H source cells, cols=H target cells):
  flat[g*L*H + d*H*H + j*H + s] = W_rec[d, s, g, j].
  peepholes: 3 blocks [ig, fg, og] of L: flat[4*L*H + q*L + d*H + j]
  = peep[d, q, j].
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

GATES = 4
PEEPS = 3

FEEDFORWARD_TYPES = {
    "feedforward_tanh": "tanh",
    "feedforward_logistic": "logistic",
    "feedforward_identity": "identity",
}

LSTM_TYPES = {"lstm": False, "blstm": True}

POSTOUTPUT_TYPES = {
    "sse", "weighted_sse", "weightedsse", "rmse", "ce", "sse_mask", "wf",
    "binary_classification", "multiclass_classification",
}


# ---------------------------------------------------------------- feedforward

def _check_size(what: str, arr: np.ndarray, want: int) -> None:
    if arr.size != want:
        raise ValueError(f"weights section: '{what}' has {arr.size} values, "
                         f"the layer needs {want}")


def ff_from_flat(inp, bias, P: int, L: int):
    inp = np.asarray(inp, dtype=np.float32)
    b = np.asarray(bias, dtype=np.float32)
    _check_size("input", inp, L * P)
    _check_size("bias", b, L)
    w = inp.reshape(L, P).T  # column-major (P, L)
    return {"W": w, "b": b}


def ff_to_flat(params):
    w = np.asarray(params["W"], dtype=np.float32)
    b = np.asarray(params["b"], dtype=np.float32)
    return w.T.reshape(-1), b, np.zeros((0,), dtype=np.float32)


# ----------------------------------------------------------------------- lstm

def lstm_from_flat(inp, bias, internal, P: int, L: int, bidirectional: bool):
    d = 2 if bidirectional else 1
    h = L // d
    inp = np.asarray(inp, dtype=np.float32)
    bias = np.asarray(bias, dtype=np.float32)
    internal = np.asarray(internal, dtype=np.float32)
    _check_size("input", inp, GATES * L * P)
    _check_size("bias", bias, GATES * L)
    _check_size("internal", internal, GATES * L * h + PEEPS * L)

    # input weights: [g, d, j, p] in flat order -> W_in[d, p, g, j]
    w_in_flat = inp.reshape(GATES, d, h, P)
    w_in = np.transpose(w_in_flat, (1, 3, 0, 2))  # (d, P, g, h)

    b = bias.reshape(GATES, d, h).transpose(1, 0, 2)  # (d, g, h)

    rec = internal[: GATES * L * h].reshape(GATES, d, h, h)  # [g, d, j, s]
    w_rec = np.transpose(rec, (1, 3, 0, 2))  # (d, s, g, j)

    peep = internal[GATES * L * h :].reshape(PEEPS, d, h).transpose(1, 0, 2)  # (d, q, h)

    return {"W_in": w_in, "W_rec": w_rec, "b": b, "peep": peep}


def lstm_to_flat(params):
    w_in = np.asarray(params["W_in"], dtype=np.float32)  # (d, P, g, h)
    w_rec = np.asarray(params["W_rec"], dtype=np.float32)  # (d, s, g, j)
    b = np.asarray(params["b"], dtype=np.float32)  # (d, g, h)
    peep = np.asarray(params["peep"], dtype=np.float32)  # (d, q, h)

    inp = np.transpose(w_in, (2, 0, 3, 1)).reshape(-1)  # [g, d, j, p]
    bias = np.transpose(b, (1, 0, 2)).reshape(-1)  # [g, d, j]
    rec = np.transpose(w_rec, (2, 0, 3, 1)).reshape(-1)  # [g, d, j, s]
    peep_flat = np.transpose(peep, (1, 0, 2)).reshape(-1)  # [q, d, j]
    internal = np.concatenate([rec, peep_flat])
    return inp, bias, internal


# -------------------------------------------------------------- whole network

def params_from_weights_section(layers: List[Dict[str, Any]], weights: Dict[str, Any]):
    """layers: parsed 'layers' array; weights: parsed 'weights' object.

    Returns dict layer_name -> param pytree (numpy) for all trainable layers
    present in the weights section.
    """
    params = {}
    prev_size = None
    for spec in layers:
        name, ltype, size = spec["name"], spec["type"], int(spec["size"])
        if ltype in FEEDFORWARD_TYPES or ltype == "softmax":
            if name in weights:
                w = weights[name]
                params[name] = ff_from_flat(w["input"], w["bias"], prev_size, size)
        elif ltype in LSTM_TYPES:
            if name in weights:
                w = weights[name]
                params[name] = lstm_from_flat(
                    w["input"], w["bias"], w["internal"], prev_size, size,
                    LSTM_TYPES[ltype],
                )
        prev_size = size
    return params


def weights_section_from_params(layers: List[Dict[str, Any]], params) -> Dict[str, Any]:
    out = {}
    for spec in layers:
        name, ltype = spec["name"], spec["type"]
        if name not in params:
            continue
        if ltype in FEEDFORWARD_TYPES or ltype == "softmax":
            inp, bias, internal = ff_to_flat(params[name])
        elif ltype in LSTM_TYPES:
            inp, bias, internal = lstm_to_flat(params[name])
        else:
            continue
        out[name] = {
            "input": np.asarray(inp, np.float64),
            "bias": np.asarray(bias, np.float64),
            "internal": np.asarray(internal, np.float64),
        }
    return out


def load_network_json(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return json.load(f)


def dump_doc_json(doc: Dict[str, Any], f) -> None:
    """json.dump(doc, f, indent=1) with numpy arrays accepted anywhere in
    the doc: the bytes of dump_doc_json_python, written faster. Each 1-D
    float array of 512 values or more is formatted by the native runtime
    (runtime/jsonfmt.cpp: Python's repr of every value, at the array's
    indentation) and spliced in where json.dumps wrote a placeholder token;
    the rest of the doc goes through json.dumps. Without the native
    library (said once on stderr), or when a string of the doc equals a
    token, the whole doc takes the pure-Python dump."""
    from lstm_rnn_tpu_torch import runtime
    if not runtime.available():
        dump_doc_json_python(doc, f)
        return
    arrays: List[np.ndarray] = []
    s = json.dumps(_plain(doc, arrays), indent=1)
    quoted = ['"%s"' % _TOKEN.format(i) for i in range(len(arrays))]
    # a doc string equal to a token would take the splice below (json
    # escapes quotes, so a token cannot hide inside a longer string)
    if any(s.count(q) != 1 for q in quoted):
        dump_doc_json_python(doc, f)
        return
    pos = 0
    for arr, q in zip(arrays, quoted):
        at = s.index(q, pos)
        # the array's depth: the indentation of the line it starts on
        line = s[s.rfind("\n", 0, at) + 1:at]
        f.write(s[pos:at])
        f.write(runtime.fmt_f64_json(
            arr, level=len(line) - len(line.lstrip(" "))).decode("ascii"))
        pos = at + len(q)
    f.write(s[pos:])


def dump_doc_json_python(doc: Dict[str, Any], f) -> None:
    """json.dump(doc, f, indent=1) with numpy arrays accepted anywhere in
    the doc, in pure Python: float arrays widen to float64 lists (every
    value printed as Python's shortest repr), integer and bool arrays keep
    their types. dump_doc_json's fallback and reference."""
    json.dump(_plain(doc), f, indent=1)


_TOKEN = "@@LRT_JSONFMT_ARRAY_{}@@"


def _plain(x, arrays: Optional[List[np.ndarray]] = None):
    """The doc as json writes it: float arrays widened to float64 lists
    (value-identical), integer and bool arrays with their parsed types.
    With `arrays`, each 1-D float array of 512 values or more is appended
    there and replaced by its token (a nested or integer array keeps its
    shape and its ints)."""
    if isinstance(x, np.ndarray):
        if not np.issubdtype(x.dtype, np.floating):
            return x.tolist()
        if arrays is not None and x.size >= 512 and x.ndim == 1:
            arrays.append(x)
            return _TOKEN.format(len(arrays) - 1)
        return np.asarray(x, np.float64).tolist()
    if isinstance(x, dict):
        return {k: _plain(v, arrays) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v, arrays) for v in x]
    return x


def save_network_json(path: str, layers: List[Dict[str, Any]], params,
                      extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a reference-compatible network JSON (saveNetwork, main.cpp:681-698).

    `extra` lets the autosave writer add configuration/optimizer state keys.
    """
    doc: Dict[str, Any] = dict(extra or {})
    doc["layers"] = layers
    doc["weights"] = weights_section_from_params(layers, params)
    # atomic publish: a crash mid-write never leaves a truncated network
    # file (same-directory temp file + os.replace)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            dump_doc_json(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
