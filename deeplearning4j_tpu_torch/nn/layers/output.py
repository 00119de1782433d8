"""Output layer: a dense head whose activation follows the loss.

Counterpart of `deeplearning4j_tpu/nn/layers/output.py`: the forward pass
(with a dense layer's input dropout and drop-connect under training), the
scored loss (`loss`, with the L2/L1 terms of the layer's own weights) and
the per-row loss without them (`rowwise_loss`).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nd import losses as L
from deeplearning4j_tpu_torch.nd.ops import activate
from deeplearning4j_tpu_torch.nn.layers.base import DenseLayer


class OutputLayer(DenseLayer):
    @staticmethod
    def forward(params, conf, x, key=None, training=False, tp=None):
        x, kdc = DenseLayer.dropped_input(conf, x, key, training, tp)
        return OutputLayer.head(conf,
                                OutputLayer.preout(params, conf, x, kdc,
                                                   training))

    @staticmethod
    def head(conf, z):
        """The activation of the pre-activation `z`."""
        loss = str(conf.loss_function).lower()
        # the head matches the loss: softmax for multiclass CE, sigmoid for
        # binary CE, the configured activation for regression
        if loss in ("mcxent", "negativeloglikelihood", "expll"):
            return activate("softmax", z)
        if loss in ("xent", "rmse_xent", "reconstruction_crossentropy"):
            return activate("sigmoid", z)
        return activate(conf.activation, z)

    @staticmethod
    def loss(params, conf, x, labels, key=None, training=False):
        out = OutputLayer.forward(params, conf, x, key, training)
        w = params["W"].float()
        l2 = conf.l2 if conf.use_regularization else 0.0
        s = L.score(labels, conf.loss_function, out, l2, torch.sum(w ** 2))
        if conf.use_regularization and conf.l1:
            s = s + conf.l1 * torch.sum(torch.abs(w))
        return s

    @staticmethod
    def rowwise_loss(params, conf, x, labels, key=None, training=False,
                     tp=None):
        """Per-example loss vector without the regularization terms, which
        the caller counts once per step."""
        out = OutputLayer.forward(params, conf, x, key, training, tp)
        return L.get_rowwise(conf.loss_function)(labels, out)
