"""Output layer: a dense head whose activation follows the loss.

Counterpart of `deeplearning4j_tpu/nn/layers/output.py`: the forward pass
(with a dense layer's input dropout and drop-connect under training), the
scored loss (`loss`, with the L2/L1 terms of the layer's own weights) and
the per-row loss without them (`rowwise_loss`).
"""

from __future__ import annotations

import numpy as np
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
    def score(params, conf, examples, labels) -> float:
        """F1 of the layer's classifications on (examples, labels), the
        reference's `OutputLayer.score(INDArray, INDArray)`: an
        `Evaluation` over the forward's class probabilities. Scale 0-1,
        higher is better, unlike `loss`, the training objective."""
        from deeplearning4j_tpu_torch.evaluation.evaluation import (
            Evaluation, _host)

        if not isinstance(examples, torch.Tensor):
            examples = torch.as_tensor(np.asarray(examples),
                                       device=params["W"].device)
            # the guard that keeps float64 off the device: it names the dtype
            if examples.dtype == torch.float64:  # lint: allow(f64-literal)
                examples = examples.float()
        with torch.inference_mode():
            probs = OutputLayer.forward(params, conf, examples)
        ev = Evaluation()
        ev.eval(_host(labels), _host(probs))
        return float(ev.f1())

    @staticmethod
    def rowwise_loss(params, conf, x, labels, key=None, training=False,
                     tp=None):
        """Per-example loss vector without the regularization terms, which
        the caller counts once per step."""
        out = OutputLayer.forward(params, conf, x, key, training, tp)
        return L.get_rowwise(conf.loss_function)(labels, out)
