"""Canonical model configurations.

Counterpart of `deeplearning4j_tpu/models/zoo.py`: the flagship
`char_transformer`, `char_lstm` (BASELINE configs[1]), `lenet5`
(configs[0]), `vgg_cifar10` (configs[2]), `mlp`, and the pretraining
recipes `dbn` and `deep_autoencoder` (with `unroll_autoencoder_stack` and
`fit_deep_autoencoder`), and the serve-precision eval slice
(`PRECISION_ERROR_BUDGETS`, `precision_eval_confs`). Each configuration is
the JAX package's, field for field, so both packages build the same
network from it.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nd.losses import LossFunction
from deeplearning4j_tpu_torch.nd.ops import Activation
from deeplearning4j_tpu_torch.nn.conf import (LayerType,
                                              MultiLayerConfiguration,
                                              NeuralNetConfiguration,
                                              OptimizationAlgorithm,
                                              PoolingType)
from deeplearning4j_tpu_torch.nn.weights import WeightInit

SGD = OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT


def _base(lr=0.1, iters=1, **kw):
    return NeuralNetConfiguration(
        optimization_algo=SGD, lr=lr, num_iterations=iters,
        activation=Activation.RELU, weight_init=WeightInit.VI,
        use_adagrad=False, momentum=0.9, **kw)


def lenet5(lr: float = 0.05, iterations: int = 1,
           dtype: str = "float32") -> MultiLayerConfiguration:
    """LeNet-5 on MNIST (BASELINE configs[0]): 1x28x28 -> conv20@5x5 ->
    pool2 -> conv50@5x5 -> pool2 -> dense500 -> softmax10. Input flat
    [B, 784]."""
    b = _base(lr=lr, iters=iterations, dtype=dtype)
    confs = (
        b.replace(layer_type=LayerType.CONVOLUTION, n_channels=1, n_out=20,
                  kernel_size=(5, 5), stride=(1, 1)),
        b.replace(layer_type=LayerType.SUBSAMPLING, kernel_size=(2, 2),
                  stride=(2, 2), pooling=PoolingType.MAX),
        b.replace(layer_type=LayerType.CONVOLUTION, n_channels=20, n_out=50,
                  kernel_size=(5, 5), stride=(1, 1)),
        b.replace(layer_type=LayerType.SUBSAMPLING, kernel_size=(2, 2),
                  stride=(2, 2), pooling=PoolingType.MAX),
        b.replace(layer_type=LayerType.DENSE, n_in=50 * 4 * 4, n_out=500),
        b.replace(layer_type=LayerType.OUTPUT, n_in=500, n_out=10,
                  activation=Activation.SOFTMAX,
                  loss_function=LossFunction.MCXENT),
    )
    return MultiLayerConfiguration(
        confs=confs, pretrain=False, backprop=True,
        input_preprocessors=((0, "ff_to_conv:1:28:28"), (4, "conv_to_ff")))


def vgg_cifar10(lr: float = 0.05, iterations: int = 1,
                width: int = 64) -> MultiLayerConfiguration:
    """VGG-style conv net for CIFAR-10 (BASELINE configs[2]): three
    [conv3x3 -> BatchNorm -> pool2] stages of width, 2*width and 4*width
    channels, then dense256 -> softmax10. Input flat [B, 3072]."""
    b = _base(lr=lr, iters=iterations)

    def conv(cin, cout):
        return b.replace(layer_type=LayerType.CONVOLUTION, n_channels=cin,
                         n_out=cout, kernel_size=(3, 3), stride=(1, 1),
                         padding=(1, 1))

    def bn(c):
        return b.replace(layer_type=LayerType.BATCH_NORM, n_in=c, n_out=c)

    def pool():
        return b.replace(layer_type=LayerType.SUBSAMPLING, kernel_size=(2, 2),
                         stride=(2, 2), pooling=PoolingType.MAX)

    w = width
    confs = (
        conv(3, w), bn(w), pool(),
        conv(w, 2 * w), bn(2 * w), pool(),
        conv(2 * w, 4 * w), bn(4 * w), pool(),
        b.replace(layer_type=LayerType.DENSE, n_in=4 * w * 4 * 4, n_out=256),
        b.replace(layer_type=LayerType.OUTPUT, n_in=256, n_out=10,
                  activation=Activation.SOFTMAX,
                  loss_function=LossFunction.MCXENT),
    )
    return MultiLayerConfiguration(
        confs=confs, backprop=True,
        input_preprocessors=((0, "ff_to_conv:3:32:32"), (9, "conv_to_ff")))


def mlp(n_in: int, hidden, n_out: int, lr: float = 0.1,
        iterations: int = 1) -> MultiLayerConfiguration:
    """Plain MLP: relu dense layers of the `hidden` widths, then a softmax
    output with the mcxent loss (bench.py's 784-512-512-10 on MNIST is
    `mlp(784, [512, 512], 10)`)."""
    b = _base(lr=lr, iters=iterations)
    dims = [n_in] + list(hidden) + [n_out]
    confs = []
    for i in range(len(dims) - 1):
        last = i == len(dims) - 2
        confs.append(b.replace(
            layer_type=LayerType.OUTPUT if last else LayerType.DENSE,
            n_in=dims[i], n_out=dims[i + 1],
            activation=Activation.SOFTMAX if last else Activation.RELU,
            loss_function=LossFunction.MCXENT))
    return MultiLayerConfiguration(confs=tuple(confs), backprop=True)


def dbn(n_in: int, hidden, n_out: int, lr: float = 0.05,
        iterations: int = 30, k: int = 1,
        finetune_iterations: int = 60) -> MultiLayerConfiguration:
    """Deep belief net (Hinton, Osindero & Teh 2006): a stack of sigmoid
    RBMs greedily pretrained with CD-k by stepped descent, then a softmax
    output finetuned with conjugate gradient at twice the lr. Features
    should lie in [0, 1] for the binary visible units."""
    b = _base(lr=lr, iters=iterations).replace(
        layer_type=LayerType.RBM, activation=Activation.SIGMOID, k=k)
    dims = [n_in] + list(hidden)
    confs = [b.replace(n_in=dims[i], n_out=dims[i + 1])
             for i in range(len(dims) - 1)]
    confs.append(b.replace(
        layer_type=LayerType.OUTPUT, n_in=dims[-1], n_out=n_out,
        activation=Activation.SOFTMAX, loss_function=LossFunction.MCXENT,
        lr=2 * lr, num_iterations=finetune_iterations,
        optimization_algo=OptimizationAlgorithm.CONJUGATE_GRADIENT))
    return MultiLayerConfiguration(confs=tuple(confs), pretrain=True,
                                   backprop=True)


def deep_autoencoder(n_in: int = 784, hidden=(400, 200, 100, 50, 25, 6),
                     lr: float = 0.05, iterations: int = 30,
                     finetune_iterations: int = 60,
                     corruption: float = 0.3) -> MultiLayerConfiguration:
    """Deep autoencoder (Hinton & Salakhutdinov 2006; the default widths
    are their Curves net): a denoising-AE encoder stack pretrained layer by
    layer, a mirrored sigmoid decoder, and a reconstruction cross-entropy
    output finetuned by conjugate gradient against the inputs (fit(x, x)).
    `fit_deep_autoencoder` runs pretrain -> unroll -> finetune."""
    if not hidden:
        raise ValueError("deep_autoencoder needs at least one hidden size")
    b = _base(lr=lr, iters=iterations).replace(
        activation=Activation.SIGMOID)
    dims = [n_in] + list(hidden)
    confs = [b.replace(layer_type=LayerType.AUTOENCODER, n_in=dims[i],
                       n_out=dims[i + 1], corruption_level=corruption)
             for i in range(len(dims) - 1)]
    # the mirrored decoder: plain sigmoid dense layers back up the stack
    rev = list(reversed(dims))
    confs += [b.replace(layer_type=LayerType.DENSE, n_in=rev[i],
                        n_out=rev[i + 1])
              for i in range(len(rev) - 2)]
    confs.append(b.replace(
        layer_type=LayerType.OUTPUT, n_in=rev[-2], n_out=n_in,
        activation=Activation.SIGMOID,
        loss_function=LossFunction.RECONSTRUCTION_CROSSENTROPY,
        num_iterations=finetune_iterations,
        optimization_algo=OptimizationAlgorithm.CONJUGATE_GRADIENT))
    return MultiLayerConfiguration(confs=tuple(confs), pretrain=True,
                                   backprop=True)


def unroll_autoencoder_stack(conf: MultiLayerConfiguration, params):
    """Hinton's unrolling for a `deep_autoencoder` net: decoder layer p
    mirrors encoder layer L-1-p, so its W becomes the pretrained encoder's
    W transposed and its b the encoder's visible bias vb. Returns a new
    params tree whose decoder leaves are new tensors (contiguous copies),
    the encoder's the same tensors."""
    n_enc = sum(1 for c in conf.confs
                if LayerType(str(c.layer_type)) == LayerType.AUTOENCODER)
    params = list(params)
    for p in range(n_enc):  # decoder positions, the output layer included
        enc = params[n_enc - 1 - p]
        dec = dict(params[n_enc + p])
        dec["W"] = enc["W"].T.contiguous()
        dec["b"] = enc["vb"].clone()
        params[n_enc + p] = dec
    return tuple(params)


def fit_deep_autoencoder(net, x):
    """pretrain (the greedy AE stack) -> unroll the decoder ->
    reconstruction finetune, for a net of a `deep_autoencoder` conf. The
    unroll is copied into the net's param tensors in place, so the
    network's captured programs keep reading them."""
    x = net._input(x)
    if net.params is None:
        net.init()
    net.pretrain(x)
    unrolled = unroll_autoencoder_stack(net.conf, net.params)
    with torch.no_grad():
        for old, new in zip(net.params, unrolled):
            for name, t in old.items():
                if new[name] is not t:
                    t.copy_(new[name])
    net.finetune(x, x)
    return net


def char_transformer(vocab: int, d_model: int = 128, n_blocks: int = 2,
                     n_heads: int = 4, max_seq_len: int = 256,
                     lr: float = 1e-3, iterations: int = 1,
                     updater: str = "adam", sparse_labels: bool = False,
                     fused_updater: bool = False,
                     attention_block_skip: bool = False,
                     attention_fused_bwd: bool = False
                     ) -> MultiLayerConfiguration:
    """Decoder-only char transformer LM: embedding (+ learned positions)
    -> n_blocks x [causal MHA, FFN] -> per-token softmax over `vocab`.
    Input [rows, S] token ids; output [rows * S, vocab]. The training
    flags are kept so the configuration equals the JAX package's."""
    b = _base(lr=lr, iters=iterations, updater=updater,
              fused_updater=fused_updater)
    confs = [b.replace(layer_type=LayerType.EMBEDDING, n_in=vocab,
                       n_out=d_model, max_seq_len=max_seq_len)]
    for _ in range(n_blocks):
        confs.append(b.replace(layer_type=LayerType.ATTENTION, n_in=d_model,
                               n_out=d_model, n_heads=n_heads, causal=True,
                               attention_block_skip=attention_block_skip,
                               attention_fused_bwd=attention_fused_bwd))
        confs.append(b.replace(layer_type=LayerType.TRANSFORMER_FFN,
                               n_in=d_model, n_out=d_model))
    confs.append(b.replace(layer_type=LayerType.OUTPUT, n_in=d_model,
                           n_out=vocab, activation=Activation.SOFTMAX,
                           loss_function=LossFunction.MCXENT,
                           sparse_labels=sparse_labels))
    return MultiLayerConfiguration(
        confs=tuple(confs), backprop=True,
        input_preprocessors=((2 * n_blocks + 1, "rnn_to_ff"),))


def char_lstm(vocab: int, hidden: int = 256, n_layers: int = 1,
              lr: float = 0.1, iterations: int = 1,
              sparse_labels: bool = False,
              embed: int = 0) -> MultiLayerConfiguration:
    """char-LSTM: n_layers LSTMs of width `hidden` -> per-step softmax over
    `vocab`, SGD with momentum 0.9. Input one-hot [rows, S, vocab], or int
    ids [rows, S] with `embed > 0` (an embedding vocab -> embed, no
    positional table, in front); output [rows * S, vocab].
    `sparse_labels=True` trains on int class-id targets [rows * S]."""
    b = _base(lr=lr, iters=iterations)
    confs = []
    if embed > 0:
        confs.append(b.replace(layer_type=LayerType.EMBEDDING, n_in=vocab,
                               n_out=embed))
    for i in range(n_layers):
        confs.append(b.replace(layer_type=LayerType.LSTM,
                               n_in=(embed if embed > 0 else vocab)
                               if i == 0 else hidden,
                               n_out=hidden,
                               activation=Activation.TANH))
    confs.append(b.replace(layer_type=LayerType.OUTPUT, n_in=hidden,
                           n_out=vocab, activation=Activation.SOFTMAX,
                           loss_function=LossFunction.MCXENT,
                           sparse_labels=sparse_labels))
    return MultiLayerConfiguration(
        confs=tuple(confs), backprop=True,
        input_preprocessors=((len(confs) - 1, "rnn_to_ff"),))


# -- the serve-precision eval slice ------------------------------------------

#: the JAX package's error budgets of the low-precision serve policies
#: (optimize/quantize.py): a softmax head budgets its top-1 disagreement
#: with the f32 forward, the reconstruction head its relative output MSE
PRECISION_ERROR_BUDGETS = {
    "lenet5": {
        "bf16": {"top1_delta": 0.05, "rel_mse": 5e-4},
        "int8": {"top1_delta": 0.10, "rel_mse": 5e-3},
    },
    "char_lstm": {
        "bf16": {"top1_delta": 0.05, "rel_mse": 5e-4},
        "int8": {"top1_delta": 0.10, "rel_mse": 5e-3},
    },
    "char_transformer": {
        "bf16": {"top1_delta": 0.08, "rel_mse": 1e-3},
        "int8": {"top1_delta": 0.15, "rel_mse": 1e-2},
    },
    "deep_autoencoder": {
        "bf16": {"rel_mse": 5e-4},
        "int8": {"rel_mse": 5e-3},
    },
}


def precision_eval_confs(small: bool = True):
    """The four models the precision eval harness runs (conv, recurrent,
    attention, reconstruction), the JAX package's; `small` for the CPU."""
    if small:
        return {
            "lenet5": lenet5(),
            "char_lstm": char_lstm(24, hidden=24, n_layers=1),
            "char_transformer": char_transformer(
                24, d_model=16, n_blocks=1, n_heads=2, max_seq_len=16),
            "deep_autoencoder": deep_autoencoder(n_in=32, hidden=(16, 8)),
        }
    return {
        "lenet5": lenet5(),
        "char_lstm": char_lstm(64, hidden=256, n_layers=1),
        "char_transformer": char_transformer(64),
        "deep_autoencoder": deep_autoencoder(),
    }
