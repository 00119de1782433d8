"""Layer registry: `LayerType` -> the layer's `init` / `forward` pair.

Counterpart of `deeplearning4j_tpu/nn/layers/__init__.py`.
`register_layer(layer_type, impl)` installs (or replaces) a type's
implementation, as in the JAX package. Every `LayerType` is ported: the
recursive autoencoder's type runs the flat denoising autoencoder, as in
the JAX package. Pretrainable layers (RBM, the autoencoders) also have
`pretrain_grad_and_score(params, conf, x, key)` and `pretrain_score`.
"""

from deeplearning4j_tpu_torch.nn.conf import LayerType
from deeplearning4j_tpu_torch.nn.layers import (attention, autoencoder, base,
                                                conv, lstm, output, rbm)

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
    LayerType.AUTOENCODER: autoencoder.AutoEncoder,
    # a recursive AE over trees is future scope in the JAX package too;
    # the flat denoising AE gives its type the pretraining contract
    LayerType.RECURSIVE_AUTOENCODER: autoencoder.AutoEncoder,
    LayerType.RBM: rbm.RBM,
}


def get_layer(layer_type):
    return _REGISTRY[LayerType(str(layer_type).lower())]


def register_layer(layer_type, impl) -> None:
    """Use `impl` (a class with the layers' `init(key, conf)` and
    `forward(params, conf, x, key=None, training=False)` static methods)
    for `layer_type`. A layer that only serves inference may take
    `forward(params, conf, x)`: inference without a key calls that form."""
    _REGISTRY[LayerType(str(layer_type).lower())] = impl
