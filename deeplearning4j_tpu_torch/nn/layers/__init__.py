"""Layer registry: `LayerType` -> the layer's `init` / `forward` pair.

Counterpart of `deeplearning4j_tpu/nn/layers/__init__.py`.
`register_layer(layer_type, impl)` installs (or replaces) a type's
implementation, as in the JAX package; `get_layer` finds a registered type
first, and a layer type that is neither registered nor ported raises
`NotImplementedError` naming the ROADMAP.md item that ports it.
"""

from deeplearning4j_tpu_torch.nn.conf import LayerType
from deeplearning4j_tpu_torch.nn.layers import (attention, base, conv, lstm,
                                                output)

_REGISTRY = {
    LayerType.DENSE: base.DenseLayer,
    LayerType.OUTPUT: output.OutputLayer,
    LayerType.EMBEDDING: base.EmbeddingLayer,
    LayerType.ATTENTION: attention.MultiHeadAttentionLayer,
    LayerType.TRANSFORMER_FFN: attention.TransformerFFNLayer,
    LayerType.LSTM: lstm.LSTMLayer,
    LayerType.GRAVES_LSTM: lstm.GravesLSTMLayer,
    LayerType.BATCH_NORM: base.BatchNormLayer,
    LayerType.CONVOLUTION: conv.ConvolutionLayer,
    LayerType.SUBSAMPLING: conv.SubsamplingLayer,
}

#: where each layer type not ported yet stands in ROADMAP.md
_PLANNED = {
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
    """Use `impl` (a class with the layers' `init(gen, conf)` and
    `forward(params, conf, x, key=None, training=False)` static methods)
    for `layer_type`. A layer that only serves inference may take
    `forward(params, conf, x)`: inference without a key calls that form."""
    _REGISTRY[LayerType(str(layer_type).lower())] = impl
