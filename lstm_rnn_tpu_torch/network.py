"""Network container: CURRENNT JSON topology -> forward pass in torch.

Counterpart of lstm_rnn_tpu/network.py. Builds the layer list from the
JSON "layers" array and validates the topology as `NeuralNetwork.cpp:96-125`
does (input first, exactly one post-output last, >= 3 layers, unique
names). Parameters are held as the JAX package holds them — numpy arrays
per layer in `net.params`, read from the JSON weights section or drawn by
`init_params` — and `params_from_numpy` moves them to a device as tensors
for `apply`, `loss` and `loss_and_count_fused`; `params_to_numpy` brings
them (or their gradients, in the same tree layout) back.

Training runs on the exact parameters: the JAX package's padded training
view (128-lane cells, network.py:352-488) is a TPU tiling rule the Hopper
kernels do not need. Streaming serving (`init_stream_state`,
`apply_streaming`) runs unidirectional stacks chunk by chunk on the carry
kernel. Sequence parallelism runs the net's layers block by block
(parallel/sequence.py). `remat_blocks` (the CLI's --remat_blocks, set in
train mode) checkpoints every LSTM layer's recurrence in K time blocks
(models/lstm.py) and takes the plain tail (K5) in `loss_and_count_fused`.
Data parallelism runs the net unchanged on each rank's block of a
fraction (parallel/data.py, the Trainer's data_group). Pipeline
parallelism runs each stage's hidden layers through `apply_layer_range`,
the last stage ending with `fused_tail` (parallel/pipeline.py). With a
`model_mesh` of more than one device (tensor parallelism, the CLI's
--model_devices) every LSTM layer takes parallel/tensor.py's cell-sharded
scan, `validate_tp` checking that the mesh divides every layer's cells.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from lstm_rnn_tpu_torch import io_currennt as ioc
from lstm_rnn_tpu_torch.models import losses as losses_mod
from lstm_rnn_tpu_torch.models.feedforward import (feedforward_forward,
                                                   softmax_forward)
from lstm_rnn_tpu_torch.models.lstm import (lstm_forward,
                                            lstm_forward_streaming)
from lstm_rnn_tpu_torch.ops.gemm import use3
from lstm_rnn_tpu_torch.ops.softmax_ce import (_no_tf32, proj_tail_fits,
                                               softmax_ce_3x_fused,
                                               softmax_ce_fused,
                                               softmax_ce_proj_fused,
                                               softmax_ce_wide_fused,
                                               tail_smem_optin,
                                               wide_tail_fits)
from lstm_rnn_tpu_torch.parallel.tensor import lstm_forward_tp
from lstm_rnn_tpu_torch.utils.rng_compat import (CurrenntInitStream,
                                                 currennt_init_flat)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


@dataclasses.dataclass
class LayerSpec:
    name: str
    type: str
    size: int
    bias: float = 0.0
    learning_rate: float = -1.0  # per-layer override; -1 = use global

    def to_json(self) -> Dict[str, Any]:
        # Layer::exportLayer + TrainableLayer::exportLayer (Layer.cpp:144-157,
        # TrainableLayer.cu:251-255): name/type/size, plus bias on trainable
        # layers; post-output types under their canonical type() string
        canonical = {"weighted_sse": "weightedsse", "sse_mask": "wf"}.get(self.type, self.type)
        d: Dict[str, Any] = {"name": self.name, "type": canonical, "size": self.size}
        if self.type != "input" and self.type not in ioc.POSTOUTPUT_TYPES:
            d["bias"] = self.bias
        return d


def params_from_numpy(params_np, device, dtype=torch.float32):
    """The JAX package's parameter tree (numpy arrays per layer) -> the
    port's tensors on `device`, in the same layout (contiguous: the JSON
    reader's arrays are transposed views)."""
    return {name: {k: torch.as_tensor(np.ascontiguousarray(v), dtype=dtype,
                                      device=device)
                   for k, v in layer.items()}
            for name, layer in params_np.items()}


def params_to_numpy(params):
    """The inverse of params_from_numpy: tensors (parameters or their
    gradients) -> float32 numpy arrays in the same tree layout. Always
    copies, on the CPU too: the arrays stay as they are while training
    updates the tensors in place (the autosave thread reads them)."""
    return {name: {k: v.detach().to("cpu", torch.float32, copy=True).numpy()
                   for k, v in layer.items()}
            for name, layer in params.items()}


class Network:
    """Functional network with CURRENNT JSON interop."""

    def __init__(self, layers_json: List[Dict[str, Any]],
                 weights_json: Optional[Dict[str, Any]] = None,
                 input_size_override: Optional[int] = None,
                 backend: str = "auto", compute_dtype: str = "float32"):
        specs: List[LayerSpec] = []
        for lc in layers_json:
            if "type" not in lc:
                raise ValueError("Missing value 'type' in layer description")
            ltype = lc["type"]
            size = int(lc["size"])
            if ltype == "input" and input_size_override and input_size_override > 0:
                size = input_size_override
            known = (
                ltype == "input"
                or ltype == "softmax"
                or ltype in ioc.FEEDFORWARD_TYPES
                or ltype in ioc.LSTM_TYPES
                or ltype in ioc.POSTOUTPUT_TYPES
            )
            if not known:
                raise ValueError(f"Unknown layer type '{ltype}'")
            trainable = ltype not in ioc.POSTOUTPUT_TYPES and ltype != "input"
            if trainable and "bias" not in lc:
                raise ValueError(f"Missing value 'bias' in layer '{lc.get('name')}'")
            if ltype == "blstm" and size % 2 != 0:
                raise ValueError("Cannot create a bidirectional layer with an odd layer size")
            specs.append(LayerSpec(
                name=lc["name"], type=ltype, size=size,
                bias=float(lc.get("bias", 0.0)),
                learning_rate=float(lc.get("learningRate", -1.0)),
            ))

        # topology validation (NeuralNetwork.cpp:96-125)
        if len(specs) < 3:
            raise ValueError("Not enough layers defined")
        if specs[0].type != "input":
            raise ValueError("The first layer is not an input layer")
        if any(s.type == "input" for s in specs[1:]):
            raise ValueError("Multiple input layers defined")
        if specs[-1].type not in ioc.POSTOUTPUT_TYPES:
            raise ValueError("The last layer is not a post output layer")
        if any(s.type in ioc.POSTOUTPUT_TYPES for s in specs[:-1]):
            raise ValueError("Multiple post output layers defined")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError("Different layers have the same name")

        # post-output size must equal the output layer size (x2 for the
        # interleaved-target losses) — PostOutputLayer.cpp:48-79
        po, ol = specs[-1], specs[-2]
        mult = 2 if po.type in ("weighted_sse", "weightedsse", "sse_mask", "wf") else 1
        if po.type == "binary_classification" and po.size != 1:
            raise ValueError("The binary classification post output layer "
                             "cannot be used for an output layer size != 1")
        if po.type == "multiclass_classification" and po.size == 1:
            raise ValueError("The multiclass classification post output layer "
                             "cannot be used for an output layer size of 1")
        if po.size != ol.size * mult:
            raise ValueError(f"Size mismatch: {po.size} vs. {ol.size * mult}")

        if compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(DTYPES)}")
        if compute_dtype == "float64" and backend != "scan":
            # the card's paths are f32 and bf16; float64 is the CPU scan
            # route's, held against the float64 oracle
            raise ValueError("compute_dtype float64 takes backend 'scan'")
        self.specs = specs
        self.backend = backend  # LSTM backend: auto|scan|pallas
        self.compute_dtype = DTYPES[compute_dtype]  # matmul operand dtype
        self.loss_fn, self.task_kind = losses_mod.LOSSES[specs[-1].type]
        self.is_classification = self.task_kind == "classification"
        # --remat_blocks K (train mode): gradient checkpointing of the LSTM
        # recurrences in K time blocks, and the plain tail; 0 = off
        self.remat_blocks = 0
        # --model_devices k (train mode): the model mesh, a list of k
        # devices over which every LSTM layer's cells are sharded
        # (parallel/tensor.py); None = no tensor parallelism
        self.model_mesh = None

        # numpy parameters: from the JSON weights section, the rest drawn
        # on demand by init_params
        self.params: Dict[str, Any] = {}
        if weights_json:
            layers_dicts = [s.to_json() for s in specs]
            self.params = ioc.params_from_weights_section(layers_dicts, weights_json)

    @property
    def output_size(self) -> int:
        return self.specs[-2].size

    @property
    def target_size(self) -> int:
        """Size of the target vectors the post-output layer consumes."""
        return self.specs[-1].size

    @property
    def param_dtype(self) -> torch.dtype:
        """The parameters' tensor dtype: float64 in float64 mode, else
        float32 (bf16 mode rounds operands, not parameters)."""
        return (torch.float64 if self.compute_dtype == torch.float64
                else torch.float32)

    def trainable_specs(self) -> List[LayerSpec]:
        return list(self.specs[1:-1])

    # ------------------------------------------------------------------- init
    def init_params(self, seed: int, dist: str = "uniform",
                    uniform_min: float = -0.1, uniform_max: float = 0.1,
                    normal_mean: float = 0.0, normal_sigma: float = 0.1,
                    init_rng: str = "numpy") -> None:
        """Randomly initialize any layer missing from the weights section
        (TrainableLayer.cu:103-125 distributions), as the JAX package's
        init_params does: init_rng "numpy" from its numpy stream, "currennt"
        replaying the reference's boost::mt19937 stream (utils/
        rng_compat.py: one engine for every layer that needs a draw, each
        layer's weights in the flat [input | bias | internal] order). The
        same seed gives the same arrays as the JAX package in both."""
        if init_rng == "currennt":
            self._init_currennt(seed, dist, uniform_min, uniform_max)
            return
        rng = np.random.RandomState(seed & 0x7FFFFFFF)

        def draw(shape):
            if dist == "uniform":
                return rng.uniform(uniform_min, uniform_max, size=shape).astype(np.float32)
            return rng.normal(normal_mean, normal_sigma, size=shape).astype(np.float32)

        prev = self.specs[0].size
        for s in self.specs[1:-1]:
            if s.name not in self.params:
                if s.type in ioc.LSTM_TYPES:
                    d = 2 if ioc.LSTM_TYPES[s.type] else 1
                    h = s.size // d
                    self.params[s.name] = {
                        "W_in": draw((d, prev, 4, h)),
                        "W_rec": draw((d, h, 4, h)),
                        "b": draw((d, 4, h)),
                        "peep": draw((d, 3, h)),
                    }
                else:
                    self.params[s.name] = {"W": draw((prev, s.size)), "b": draw((s.size,))}
            prev = s.size

    def _init_currennt(self, seed: int, dist: str, lo: float,
                       hi: float) -> None:
        """init_params(init_rng="currennt")."""
        if dist != "uniform" and any(s.name not in self.params
                                     for s in self.specs[1:-1]):
            # refused only when some layer needs a draw: a fully weighted
            # network (--continue) never touches the normal stream
            currennt_init_flat(None, 0, dist, 0.0, 0.0)
        stream = CurrenntInitStream(seed)
        prev = self.specs[0].size
        for s in self.specs[1:-1]:
            if s.name not in self.params:
                if s.type in ioc.LSTM_TYPES:
                    bidir = ioc.LSTM_TYPES[s.type]
                    h = s.size // (2 if bidir else 1)
                    # 4 input weights and 4h + 3 internal weights a block
                    # (TrainableLayer.cu:104, LstmLayer.hpp:36-55)
                    flat = currennt_init_flat(
                        stream, s.size * (4 * (prev + 1) + 4 * h + 3), dist,
                        lo, hi)
                    n_in, n_b = 4 * s.size * prev, 4 * s.size
                    self.params[s.name] = ioc.lstm_from_flat(
                        flat[:n_in], flat[n_in:n_in + n_b], flat[n_in + n_b:],
                        prev, s.size, bidir)
                else:
                    flat = currennt_init_flat(stream, s.size * (prev + 1),
                                              dist, lo, hi)
                    self.params[s.name] = ioc.ff_from_flat(
                        flat[:s.size * prev], flat[s.size * prev:], prev,
                        s.size)
            prev = s.size

    def device_params(self, device):
        """`self.params` as tensors on `device` (float32, or float64 in
        float64 mode)."""
        return params_from_numpy(self.params, device, self.param_dtype)

    # ---------------------------------------------------------------- forward
    def apply(self, params, inputs: torch.Tensor,
              pattypes: torch.Tensor) -> torch.Tensor:
        """Forward pass to the output layer's activations.

        params: from device_params; inputs: [T, B, input_size] float32;
        pattypes: [T, B] int8, on the params' device.
        Returns [T, B, output_size] float32.
        """
        return self.apply_layer_range(params, inputs, pattypes, 0,
                                      len(self.specs) - 2)

    def apply_layer_range(self, params, x, pattypes, lo: int, hi: int):
        """Hidden layers [lo, hi) (0-indexed into specs[1:-1], the softmax
        layer counted): a pipeline stage's work (parallel/pipeline.py) and
        the whole of `apply` (lstm_rnn_tpu/network.py:243-273)."""
        return self._apply_layers(params, x, pattypes,
                                  self.specs[1 + lo:1 + hi])

    def _apply_layers(self, params, x, pattypes, specs, state=None):
        """The layers of `specs` in order. With `state` (streaming), each
        LSTM layer runs one chunk from its carried state and the new state
        is returned beside the output. With a model mesh, consecutive LSTM
        layers hand each other the full output already on every device of
        the mesh (lstm_forward_tp's replicas)."""
        new_state = {}
        replicas = None  # the previous TP layer's output on each device
        for s in specs:
            p = params[s.name]
            tp = self._tp_size() > 1 and s.type in ioc.LSTM_TYPES
            if tp and state is None:
                replicas = lstm_forward_tp(
                    p, replicas or x, pattypes, s.bias,
                    ioc.LSTM_TYPES[s.type], self.model_mesh, name=s.name)
                x = replicas[0]
                continue
            replicas = None
            if s.type in ioc.LSTM_TYPES and state is not None:
                x, new_state[s.name] = lstm_forward_streaming(
                    p, x, pattypes, s.bias, state[s.name],
                    backend=self.backend, compute_dtype=self.compute_dtype)
            elif s.type in ioc.LSTM_TYPES:
                x = lstm_forward(p, x, pattypes, s.bias, ioc.LSTM_TYPES[s.type],
                                 backend=self.backend,
                                 compute_dtype=self.compute_dtype,
                                 remat_blocks=self.remat_blocks)
            elif s.type == "softmax":
                x = softmax_forward(p, x, s.bias, self.compute_dtype)
            else:
                x = feedforward_forward(p, x, ioc.FEEDFORWARD_TYPES[s.type],
                                        s.bias, self.compute_dtype)
        return x if state is None else (x, new_state)

    # ----------------------------------------------- tensor parallelism
    def _tp_size(self) -> int:
        return len(self.model_mesh) if self.model_mesh else 1

    def validate_tp(self) -> None:
        """Every LSTM layer's cells per direction must divide over the
        model mesh (parallel/tensor.py shards them evenly), refused in the
        JAX package's words (lstm_rnn_tpu/network.py:280-291)."""
        n = self._tp_size()
        if n <= 1:
            return
        for s in self.specs[1:-1]:
            if s.type in ioc.LSTM_TYPES:
                d = 2 if ioc.LSTM_TYPES[s.type] else 1
                if (s.size // d) % n:
                    raise ValueError(
                        f"model_devices={n} must divide layer '{s.name}' "
                        f"cells per direction ({s.size // d})")

    # ------------------------------------------------- streaming inference
    #
    # Online serving for UNIDIRECTIONAL stacks: the input arrives in time
    # chunks and each LSTM layer's (h, c) is carried from call to call.
    # Chained chunks give apply() on the concatenation. Bidirectional
    # layers cannot stream (the backward half needs the future) and are
    # refused up front.

    def init_stream_state(self, batch: int, device="cuda"):
        """Zero (h, c), [1, batch, H] f32 each, per LSTM layer, on `device`
        (the card unless the caller asks for the CPU), for apply_streaming.
        Raises ValueError naming a bidirectional layer."""
        state = {}
        for s in self.specs[1:-1]:
            if s.type in ioc.LSTM_TYPES:
                if ioc.LSTM_TYPES[s.type]:
                    raise ValueError(
                        f"layer '{s.name}' is bidirectional — blstm nets "
                        "cannot stream (the backward half consumes the "
                        "future); use the whole-sequence forward mode")
                z = torch.zeros((1, batch, s.size), dtype=torch.float32,
                                device=device)
                state[s.name] = (z, z)
        return state

    def apply_streaming(self, params, inputs: torch.Tensor,
                        pattypes: torch.Tensor, state):
        """One chunk's forward pass: inputs [Tc, B, input_size], pattypes
        [Tc, B], state from init_stream_state or the previous chunk.
        Returns (y [Tc, B, output_size], new_state)."""
        return self._apply_layers(params, inputs, pattypes, self.specs[1:-1],
                                  state)

    def loss(self, params, inputs, targets, pattypes):
        """Total error over the fraction (the reference's calculateError
        sum), through the unfused post-output layer."""
        return self.loss_fn(self.apply(params, inputs, pattypes), targets,
                            pattypes)

    def correct_count(self, y, targets, pattypes):
        if self.specs[-1].type == "binary_classification":
            return losses_mod.binary_correct_count(y, targets, pattypes)
        if self.specs[-1].type == "multiclass_classification":
            return losses_mod.multiclass_correct_count(y, targets, pattypes)
        return torch.zeros((), dtype=torch.int32, device=y.device)

    # --------------------------------------------- fused classification tail
    def supports_fused_tail(self) -> bool:
        """True when the net ends softmax -> multiclass_classification, the
        shape every ASR recipe uses: the whole tail (CURRENNT softmax,
        -log p[target] loss, argmax count, Jacobian backward) then runs in
        the kernel pair of ops/softmax_ce.py."""
        return (self.specs[-2].type == "softmax"
                and self.specs[-1].type == "multiclass_classification")

    def takes_fused_tail(self) -> bool:
        """The Trainer's and the pipeline's last stage's choice: the fused
        tail on the kernel backends wherever the net ends in it."""
        return self.backend != "scan" and self.supports_fused_tail()

    def loss_and_count_fused(self, params, inputs, targets, pattypes):
        """(total error, correct count) through the fused softmax + CE tail:
        the hidden layers as in `apply`, then the softmax layer's product,
        the softmax, the loss and the count, with the tail's backward
        kernels under autograd. targets [T, B] int (-1 = dummy).

        Under remat (`remat_blocks` > 0) the tail is K5, as in the JAX
        package: the logits materialized by the softmax layer's product
        outside (feedforward_forward, under autograd), then the plain
        kernel pair (softmax_ce_fused). Otherwise it is K3 (the product
        inside the kernel) when its forward fits a block's shared memory
        (`proj_tail_fits`: S <= 704 on the H100, and on the CPU,
        which takes the H100's route), and K4 (the product outside, the
        wide kernels) above: the LVCSR recipe's 10,112 states, where K4b
        takes P (`wide_tail_fits`: P <= 1,024), else K5 again, as the
        JAX package falls back where its wide_plan refuses. The JAX
        package reaches K5 under remat because its tail takes K3 and K4
        only on the padded view, which remat drops; the port has no padded
        view, so remat itself is the route. Under --f32_matmul 3x
        (ops/gemm.py `use3`) K3's route takes `softmax_ce_3x_fused`: its
        products in the engine's 3x instance around K5, where K3f and K3b
        have no 3x body."""
        x = self.apply_layer_range(params, inputs, pattypes, 0,
                                   len(self.specs) - 3)
        return self.fused_tail(params, x, targets)

    def fused_tail(self, params, x, targets):
        """(total error, correct count) of the fused tail alone, from the
        softmax layer's input x [T, B, P] on its device: the route of
        `loss_and_count_fused`, which a pipeline's last stage ends with."""
        if not self.supports_fused_tail():
            raise ValueError("the fused tail needs a softmax -> "
                             "multiclass_classification net")
        s = self.specs[-2]
        t, b, p_dim = x.shape
        n = t * b
        proj = proj_tail_fits(s.size, tail_smem_optin(x.device))
        if self.remat_blocks > 0 or not (proj or wide_tail_fits(p_dim)):
            if x.is_cuda:
                _no_tf32(self.compute_dtype)
            a = feedforward_forward(params[s.name], x, "identity", s.bias,
                                    self.compute_dtype)
            return softmax_ce_fused(a.reshape(n, s.size), targets.reshape(n),
                                    s.size, self.compute_dtype)
        if proj and use3(self.compute_dtype):
            return softmax_ce_3x_fused(
                x.reshape(n, p_dim), params[s.name]["W"], params[s.name]["b"],
                targets.reshape(n), s.size, float(s.bias))
        tail = softmax_ce_proj_fused if proj else softmax_ce_wide_fused
        return tail(
            x.reshape(n, p_dim), params[s.name]["W"], params[s.name]["b"],
            targets.reshape(n), s.size, float(s.bias), self.compute_dtype)

    def get_outputs(self, y, seq_info) -> tuple:
        """Segment padded activations back into per-sequence outputs
        (NeuralNetwork::getOutputs, NeuralNetwork.cpp:238-262).

        y: [T, B, out] (tensor or array); seq_info: the Fraction's
        per-sequence metadata. Returns (tags, [np.ndarray [len_i, out]]).
        """
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        tags, outs = [], []
        for i, info in enumerate(seq_info):
            tags.append(info["tag"])
            outs.append(y[: info["length"], i, :])
        return tags, outs

    # ------------------------------------------------------------------- JSON
    @classmethod
    def from_json_file(cls, path: str, input_size_override: Optional[int] = None,
                       **kwargs) -> "Network":
        doc = ioc.load_network_json(path)
        if "layers" not in doc:
            raise ValueError("Missing section 'layers'")
        return cls(doc["layers"], doc.get("weights"),
                   input_size_override=input_size_override, **kwargs)

    def layers_json(self) -> List[Dict[str, Any]]:
        return [s.to_json() for s in self.specs]

    def save(self, path: str) -> None:
        ioc.save_network_json(path, self.layers_json(), self.params)
