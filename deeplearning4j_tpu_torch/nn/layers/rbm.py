"""Restricted Boltzmann machine trained by CD-k contrastive divergence.

Counterpart of `deeplearning4j_tpu/nn/layers/rbm.py`: the four unit types
(BINARY, GAUSSIAN, RECTIFIED (NReLU), SOFTMAX) of visible and hidden
units, propUp/propDown, the Gibbs chain with the JAX package's keys
(`fold_in(key, 0)` for the first hidden sample, then `2i + 1` and `2i + 2`
for step i), and the CD-k gradient formed directly (CD-k is not the
gradient of a loss, so there is no autograd here). The score is the mean
reconstruction cross-entropy (MSE for Gaussian visibles).

The unit samples are the JAX package's draws: a Bernoulli compares the
threefry uniforms with p = sigmoid(pre) element by element, so a sample
equals JAX's wherever p does; p can differ from XLA's in the last place,
and a uniform that lies within that gap flips.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nd import losses as L
from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nn.conf import RBMUnit
from deeplearning4j_tpu_torch.nn.layers.autoencoder import (AutoEncoder,
                                                            pretrain_params)
from deeplearning4j_tpu_torch.nn.layers.base import promoted_matmul


def _unit_mean(kind, pre: torch.Tensor) -> torch.Tensor:
    kind = RBMUnit(str(kind))
    if kind == RBMUnit.BINARY:
        return torch.sigmoid(pre)
    if kind == RBMUnit.GAUSSIAN:
        return pre
    if kind == RBMUnit.RECTIFIED:
        return torch.relu(pre)
    if kind == RBMUnit.SOFTMAX:
        return torch.softmax(pre, dim=-1)
    raise ValueError(kind)


def _unit_sample(kind, key, pre: torch.Tensor) -> torch.Tensor:
    kind = RBMUnit(str(kind))
    if kind == RBMUnit.BINARY:
        return nd_random.bernoulli(key, torch.sigmoid(pre)).to(pre.dtype)
    if kind == RBMUnit.GAUSSIAN:
        return pre + nd_random.normal(key, 0.0, 1.0, pre.shape, pre.dtype)
    if kind == RBMUnit.RECTIFIED:
        # NReLU (Nair & Hinton): max(0, pre + N(0, sigmoid(pre)))
        sigma = torch.sqrt(torch.sigmoid(pre))
        return torch.relu(pre + sigma * nd_random.normal(
            key, 0.0, 1.0, pre.shape, pre.dtype))
    if kind == RBMUnit.SOFTMAX:
        # one sample a row from the softmax, one-hot; one key for the
        # whole array, as JAX draws it
        idx = nd_random.categorical_joint(key, pre)
        return torch.nn.functional.one_hot(idx, pre.shape[-1]).to(pre.dtype)
    raise ValueError(kind)


def _recon_score(conf, x, recon):
    if RBMUnit(str(conf.visible_unit)) == RBMUnit.GAUSSIAN:
        return L.get_loss("mse")(x, recon)
    return L.get_loss("xent")(torch.clamp(x, 0.0, 1.0),
                              torch.clamp(recon, 1e-7, 1 - 1e-7))


class RBM(AutoEncoder):
    init = staticmethod(pretrain_params)
    #: CD-k is not the gradient of a loss: no loss to differentiate twice
    pretrain_loss = None

    @staticmethod
    def prop_up(params, conf, v):
        return _unit_mean(conf.hidden_unit,
                          promoted_matmul(v, params["W"]) + params["b"])

    @staticmethod
    def prop_down(params, conf, h):
        return _unit_mean(conf.visible_unit,
                          promoted_matmul(h, params["W"].T) + params["vb"])

    @staticmethod
    def sample_h_given_v(params, conf, key, v, draw: bool = True):
        """(mean, sample) of the hidden units; `draw=False` skips the
        sample (None), which no value of the chain's last step reads."""
        pre = v @ params["W"] + params["b"]
        return (_unit_mean(conf.hidden_unit, pre),
                _unit_sample(conf.hidden_unit, key, pre) if draw else None)

    @staticmethod
    def sample_v_given_h(params, conf, key, h):
        pre = h @ params["W"].T + params["vb"]
        return (_unit_mean(conf.visible_unit, pre),
                _unit_sample(conf.visible_unit, key, pre))

    @staticmethod
    def forward(params, conf, x, key=None, training=False):
        return RBM.prop_up(params, conf, x)

    @staticmethod
    def reconstruct(params, conf, x):
        return RBM.prop_down(params, conf, RBM.prop_up(params, conf, x))

    @staticmethod
    def uses_key(conf) -> bool:
        return True

    @staticmethod
    def gibbs(params, conf, key, v0, k: int):
        """k alternating Gibbs steps from v0: (v_k, h_k mean). The last
        hidden sample is not drawn: nothing reads it (JAX's jit drops it
        alike)."""
        h_mean, h_sample = RBM.sample_h_given_v(
            params, conf, nd_random.fold_in(key, 0), v0)
        v = v0
        for i in range(k):
            kv = nd_random.fold_in(key, 2 * i + 1)
            kh = nd_random.fold_in(key, 2 * i + 2)
            _, v = RBM.sample_v_given_h(params, conf, kv, h_sample)
            h_mean, h_sample = RBM.sample_h_given_v(params, conf, kh, v,
                                                    draw=i + 1 < k)
        return v, h_mean

    @staticmethod
    def pretrain_grad_and_score(params, conf, x, key=None):
        """The CD-k gradient (as a direction to minimize along) and the
        reconstruction score, with L2 on W and the sparsity target on the
        hidden bias."""
        with torch.no_grad():
            B = x.shape[0]
            h0_mean = RBM.prop_up(params, conf, x)
            vk, hk_mean = RBM.gibbs(params, conf, key, x, max(1, conf.k))
            gW = -(x.T @ h0_mean - vk.T @ hk_mean) / B
            gb = -torch.mean(h0_mean - hk_mean, dim=0)
            gvb = -torch.mean(x - vk, dim=0)
            if conf.use_regularization and conf.l2:
                gW = gW + conf.l2 * params["W"]
            if conf.sparsity > 0.0:
                gb = gb + (torch.mean(h0_mean, dim=0) - conf.sparsity)
            score = _recon_score(conf, x, RBM.reconstruct(params, conf, x))
        return {"W": gW, "b": gb, "vb": gvb}, score

    @staticmethod
    def pretrain_score(params, conf, x, key=None):
        """The reconstruction score alone: no Gibbs chain, no gradient."""
        with torch.no_grad():
            return _recon_score(conf, x, RBM.reconstruct(params, conf, x))

    @staticmethod
    def free_energy(params, conf, v):
        """F(v) = -v.vb - sum softplus(v.W + b) (binary units)."""
        wx_b = v @ params["W"] + params["b"]
        return -v @ params["vb"] - torch.sum(
            torch.nn.functional.softplus(wx_b), dim=-1)
