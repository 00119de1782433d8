"""Denoising autoencoder (the recursive autoencoder's type maps here too).

Counterpart of `deeplearning4j_tpu/nn/layers/autoencoder.py`: tied-weight
encode/decode with a visible bias `vb`, binomial input corruption drawn
from the layer's key (the JAX package's threefry mask, bit for bit), the
reconstruction loss, L2 and KL sparsity. As a hidden layer of a network it
is a dense layer (`forward` encodes); `pretrain_grad_and_score` and
`pretrain_score` are the layer-wise pretraining objective, with gradients
by autograd.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nd import losses as L
from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nd.ops import activate
from deeplearning4j_tpu_torch.nn.layers.base import (DenseLayer, _sampler,
                                                     param_dtype,
                                                     promoted_matmul)
from deeplearning4j_tpu_torch.nn.weights import init_weights


def pretrain_params(key, conf) -> dict:
    """W [n_in, n_out] drawn from `key` as the conf initializes it, hidden
    bias b and visible bias vb at zero: the params of both pretraining
    layers (the RBM draws W from its layer key, as the JAX package's
    does)."""
    dt = param_dtype(conf)
    return {
        "W": init_weights(key, (conf.n_in, conf.n_out), conf.weight_init,
                          _sampler(conf), dt),
        "b": torch.zeros((conf.n_out,), dtype=dt, device=key.device),
        "vb": torch.zeros((conf.n_in,), dtype=dt, device=key.device),
    }


class AutoEncoder(DenseLayer):
    @staticmethod
    def init(key, conf):
        """`pretrain_params` of the first half of the layer key's split
        (JAX's `kw, _ = split(key)`)."""
        return pretrain_params(nd_random.split(key)[0], conf)

    @staticmethod
    def encode(params, conf, x):
        return activate(conf.activation,
                        promoted_matmul(x, params["W"]) + params["b"])

    @staticmethod
    def decode(params, conf, h):
        return activate(conf.activation,
                        promoted_matmul(h, params["W"].T) + params["vb"])

    @staticmethod
    def forward(params, conf, x, key=None, training=False):
        return AutoEncoder.encode(params, conf, x)

    @staticmethod
    def reconstruct(params, conf, x):
        return AutoEncoder.decode(params, conf,
                                  AutoEncoder.encode(params, conf, x))

    @staticmethod
    def uses_key(conf) -> bool:
        """Whether the pretraining objective draws from its key: only the
        corruption mask does."""
        return conf.corruption_level > 0.0

    @staticmethod
    def pretrain_loss(params, conf, x, key=None):
        """The denoising reconstruction loss: x corrupted by a Bernoulli(1 -
        corruption_level) mask from `key`, encoded and decoded, scored
        against the clean x (mcxent reads as reconstruction cross-entropy),
        plus 0.5 * l2 * |W|^2 and the KL sparsity penalty."""
        if conf.corruption_level > 0.0 and key is not None:
            xc = x * nd_random.binomial(key, 1.0 - conf.corruption_level,
                                        x.shape, x.dtype)
        else:
            xc = x
        h = AutoEncoder.encode(params, conf, xc)
        recon = AutoEncoder.decode(params, conf, h)
        lf = (conf.loss_function if str(conf.loss_function) != "mcxent"
              else "reconstruction_crossentropy")
        s = L.get_loss(lf)(x, recon)
        if conf.use_regularization and conf.l2:
            s = s + 0.5 * conf.l2 * torch.sum(params["W"].float() ** 2)
        if conf.sparsity > 0.0:
            rho_hat = torch.clamp(torch.mean(h, dim=0), 1e-6, 1 - 1e-6)
            rho = conf.sparsity
            s = s + torch.sum(rho * torch.log(rho / rho_hat)
                              + (1 - rho) * torch.log((1 - rho)
                                                      / (1 - rho_hat)))
        return s

    @staticmethod
    def pretrain_grad_and_score(params, conf, x, key=None):
        """(grads, score) of `pretrain_loss` by autograd."""
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            s = AutoEncoder.pretrain_loss(leaves, conf, x, key)
        grads = torch.autograd.grad(s, list(leaves.values()),
                                    allow_unused=True)
        return ({k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}, s.detach())

    @staticmethod
    def pretrain_score(params, conf, x, key=None):
        """The score alone (the line search's probes)."""
        with torch.no_grad():
            return AutoEncoder.pretrain_loss(params, conf, x, key)
