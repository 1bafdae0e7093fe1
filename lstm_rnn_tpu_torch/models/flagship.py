"""Flagship model builders: the TIMIT 183-state DBLSTM recipe and the
LVCSR physical-state recipe.

Counterpart of lstm_rnn_tpu/models/flagship.py.
`examples/phoneme_recognition_timit/{config.cfg,network.jsn}`: 117-dim
fbank input -> 5 x BLSTM(250) -> softmax(183) -> multiclass_classification,
parallel_sequences 50. `examples/lvcsr_physical_states/`: the same stack
with a softmax over 10,112 physical HMM states.
"""

from __future__ import annotations

from lstm_rnn_tpu_torch.network import Network


def timit_dblstm_layers(input_size: int = 117, hidden: int = 250,
                        depth: int = 5, num_states: int = 183):
    layers = [{"name": "input", "type": "input", "size": input_size}]
    for i in range(depth):
        layers.append({"name": f"blstm_level_{i}", "type": "blstm",
                       "size": hidden, "bias": 1.0})
    layers.append({"name": "output", "type": "softmax", "size": num_states,
                   "bias": 1.0})
    layers.append({"name": "postoutput", "type": "multiclass_classification",
                   "size": num_states})
    return layers


def build_timit_network(input_size: int = 117, hidden: int = 250,
                        depth: int = 5, num_states: int = 183,
                        seed: int = 42, **net_kwargs) -> Network:
    net = Network(timit_dblstm_layers(input_size, hidden, depth, num_states),
                  **net_kwargs)
    net.init_params(seed)
    return net


def build_lvcsr_network(num_states: int = 10112, seed: int = 42,
                        **net_kwargs) -> Network:
    """The LVCSR recipe: the TIMIT stack with a softmax over physical
    HMM-state indices (~10k decision-tree states, `htk2nc --no_label_map`).
    The state count routes its tail through the wide kernels (K4)."""
    return build_timit_network(num_states=num_states, seed=seed,
                               **net_kwargs)
