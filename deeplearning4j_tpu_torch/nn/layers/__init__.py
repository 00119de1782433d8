"""Layer registry: `LayerType` -> the layer's `init` / `forward` pair.

Counterpart of `deeplearning4j_tpu/nn/layers/__init__.py`.
`register_layer(layer_type, impl)` installs (or replaces) a type's
implementation, as in the JAX package; `get_layer` finds a registered type
first, and a layer type that is neither registered nor ported raises
`NotImplementedError` naming the ROADMAP.md item that ports it.
"""

from deeplearning4j_tpu_torch.nn.conf import LayerType
from deeplearning4j_tpu_torch.nn.layers import attention, base, lstm, output

_REGISTRY = {
    LayerType.DENSE: base.DenseLayer,
    LayerType.OUTPUT: output.OutputLayer,
    LayerType.EMBEDDING: base.EmbeddingLayer,
    LayerType.ATTENTION: attention.MultiHeadAttentionLayer,
    LayerType.TRANSFORMER_FFN: attention.TransformerFFNLayer,
    LayerType.LSTM: lstm.LSTMLayer,
    LayerType.GRAVES_LSTM: lstm.GravesLSTMLayer,
}

#: where each layer type not ported yet stands in ROADMAP.md
_PLANNED = {
    LayerType.BATCH_NORM: "queue A item 3",
    LayerType.CONVOLUTION: "queue A item 9",
    LayerType.SUBSAMPLING: "queue A item 9",
    LayerType.RBM: "queue A item 9",
    LayerType.AUTOENCODER: "queue A item 9",
    LayerType.RECURSIVE_AUTOENCODER: "queue A item 9",
}


def get_layer(layer_type):
    lt = LayerType(str(layer_type).lower())
    if lt in _REGISTRY:
        return _REGISTRY[lt]
    raise NotImplementedError(
        f"layer type '{lt}' is not ported to deeplearning4j_tpu_torch yet; "
        f"see ROADMAP.md {_PLANNED[lt]}")


def register_layer(layer_type, impl) -> None:
    """Use `impl` (a class with the layers' `init` / `forward` static
    methods) for `layer_type`."""
    _REGISTRY[LayerType(str(layer_type).lower())] = impl
