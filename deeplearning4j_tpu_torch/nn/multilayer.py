"""MultiLayerNetwork: a configuration plus a tuple of per-layer params.

Counterpart of `deeplearning4j_tpu/nn/multilayer.py`: `init_params`,
`feed_forward`, `network_output`, the losses (`network_loss`,
`network_rowwise_loss`, `make_finetune_loss`, `network_regularization`),
and `MultiLayerNetwork` with `init` / `output` / `predict` / `score` /
`evaluate` / `fit` / `serve`. Params are a tuple of dicts of tensors with the JAX
package's key names, so `parallel/checkpoint.py` carries weights both ways.
Gradients come from autograd through the plain forward.

Not ported yet: dropout under training (JAX's threefry masks cannot be
reproduced; ROADMAP.md queue A item 3), BatchNorm training, layer-wise
pretraining, and `fit(checkpoint_dir=...)`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd.platform import resolve_device
from deeplearning4j_tpu_torch.nn.conf import LayerType, MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import get_layer
from deeplearning4j_tpu_torch.nn.layers.base import check_ids
from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
from deeplearning4j_tpu_torch.nn.layers.preprocessor import apply_preprocessor
from deeplearning4j_tpu_torch.optimize import solver as solver_mod
from deeplearning4j_tpu_torch.optimize.listeners import \
    dispatch as dispatch_listeners


def init_params(conf: MultiLayerConfiguration,
                gen: torch.Generator) -> tuple:
    """Every layer's params, drawn in order from `gen` on its device."""
    return tuple(get_layer(c.layer_type).init(gen, c) for c in conf.confs)


def feed_forward(conf: MultiLayerConfiguration, params, x) -> list:
    """Activations after each layer."""
    acts = []
    for i in range(conf.n_layers):
        c = conf.conf(i)
        x = apply_preprocessor(conf.preprocessor(i), x)
        x = get_layer(c.layer_type).forward(params[i], c, x)
        acts.append(x)
    return acts


def network_output(conf: MultiLayerConfiguration, params, x):
    acts = feed_forward(conf, params, x)
    return acts[-1] if acts else x


def _check_trainable(conf: MultiLayerConfiguration) -> None:
    for i, c in enumerate(conf.confs):
        if c.dropout > 0.0:
            raise NotImplementedError(
                f"layer {i} has dropout {c.dropout}: dropout under training "
                f"is not ported to deeplearning4j_tpu_torch yet (the JAX "
                f"package's threefry masks cannot be reproduced); see "
                f"ROADMAP.md queue A item 3")


def _hidden(conf: MultiLayerConfiguration, params, x, training: bool):
    """The input of the output layer: every hidden layer's forward and the
    output layer's preprocessor."""
    if training:
        _check_trainable(conf)
    h = x
    for i in range(conf.n_layers - 1):
        c = conf.conf(i)
        h = apply_preprocessor(conf.preprocessor(i), h)
        h = get_layer(c.layer_type).forward(params[i], c, h)
    return apply_preprocessor(conf.preprocessor(conf.n_layers - 1), h)


def network_loss(conf: MultiLayerConfiguration, params, x, labels,
                 training: bool = True):
    """End-to-end loss: hidden forward + the output layer's scored loss,
    plus 0.5 * l2 * |W|^2 of every hidden layer when the output layer
    regularizes. `training` only decides whether dropout would apply (it
    raises: not ported)."""
    n = conf.n_layers
    out_conf = conf.conf(n - 1)
    h = _hidden(conf, params, x, training)
    loss = OutputLayer.loss(params[n - 1], out_conf, h, labels)
    if out_conf.use_regularization and out_conf.l2:
        for i in range(n - 1):
            if "W" in params[i]:
                loss = loss + 0.5 * out_conf.l2 * torch.sum(
                    params[i]["W"].float() ** 2)
    return loss


def network_rowwise_loss(conf: MultiLayerConfiguration, params, x, labels,
                         training: bool = True):
    """Per-label-row loss vector, no regularization (see
    `network_regularization`). Rows follow `labels`' leading dim, e.g.
    B*T for a sequence model whose `rnn_to_ff` flattens time. A BATCH_NORM
    layer raises NotImplementedError (its layer is not ported)."""
    n = conf.n_layers
    h = _hidden(conf, params, x, training)
    return OutputLayer.rowwise_loss(params[n - 1], conf.conf(n - 1), h,
                                    labels)


def network_regularization(conf: MultiLayerConfiguration, params):
    """The regularization half of `network_loss` (L2 across layers and the
    output layer's L1) as one f32 scalar."""
    out_conf = conf.conf(conf.n_layers - 1)
    reg = torch.zeros((), dtype=torch.float32,
                      device=params[-1]["W"].device)
    if not out_conf.use_regularization:
        return reg
    if out_conf.l2:
        for p in params:
            if "W" in p:
                reg = reg + 0.5 * out_conf.l2 * torch.sum(p["W"].float() ** 2)
    if out_conf.l1:
        reg = reg + out_conf.l1 * torch.sum(torch.abs(params[-1]["W"].float()))
    return reg


def make_finetune_loss(conf: MultiLayerConfiguration):
    """Row-weighted loss `(params, x, y, w) -> scalar`: the w-weighted mean
    of `network_rowwise_loss` over the rows whose weight is not 0, plus
    `network_regularization`. w is one weight per label row (padding rows
    carry 0)."""

    def loss_fn(params, x, y, w):
        rows = network_rowwise_loss(conf, params, x, y, training=True)
        return (torch.dot(rows, w) / torch.clamp(w.sum(), min=1.0)
                + network_regularization(conf, params))

    return loss_fn


class MultiLayerNetwork:
    """A network on one device. `device=None` means CUDA, and raises on a
    machine without a GPU; pass `device="cpu"` to run on the CPU."""

    def __init__(self, conf: MultiLayerConfiguration, device=None,
                 seed: Optional[int] = None):
        self.conf = conf
        self.device = resolve_device(device)
        if seed is None:
            seed = conf.confs[0].seed if conf.confs else 123
        self.seed = int(seed)
        self.params: Optional[tuple] = None
        self.listeners: List = []

    def init(self) -> "MultiLayerNetwork":
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.params = init_params(self.conf, gen)
        return self

    def set_listeners(self, listeners) -> None:
        self.listeners = list(listeners)

    def _input(self, x) -> torch.Tensor:
        """Features or labels as a tensor on the network's device (float64
        becomes float32)."""
        x = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x)
        if x.dtype == torch.float64:
            x = x.float()
        return x.to(self.device)

    def check_input(self, x) -> None:
        """Raise ValueError, on the host, for input the first layer cannot
        take: token ids outside [0, vocab) for an embedding. The batcher
        calls it per request, so one bad request neither reaches the
        device nor fails the batch it would have joined."""
        c = self.conf.conf(0)
        if c.layer_type == LayerType.EMBEDDING:
            check_ids(torch.as_tensor(np.asarray(x)).long(), c.n_in)

    def output(self, x) -> torch.Tensor:
        """The network's output on `x`, as a tensor on the network's
        device."""
        with torch.inference_mode():
            return network_output(self.conf, self.params, self._input(x))

    def predict(self, x) -> np.ndarray:
        return self.output(x).argmax(dim=-1).cpu().numpy()

    def score(self, x, labels) -> float:
        """The network's loss on (x, labels), regularization included."""
        with torch.inference_mode():
            return float(network_loss(self.conf, self.params, self._input(x),
                                      self._input(labels), training=False))

    def evaluate(self, data, labels=None, batch_size: int = 0,
                 prefetch: bool = True):
        """Classifier metrics over `data` (or the pair data, labels), batch
        by batch; see `evaluation.evaluate`."""
        from deeplearning4j_tpu_torch.evaluation import evaluate

        if labels is not None:
            from deeplearning4j_tpu_torch.datasets.dataset import DataSet

            data = DataSet(np.asarray(data), np.asarray(labels))
        return evaluate(self, data, batch_size=batch_size, prefetch=prefetch)

    # -- training ------------------------------------------------------------
    def finetune(self, x, labels) -> None:
        """Supervised end-to-end optimization of `network_loss` on one batch
        with the output layer's solver. The updater state starts at zero on
        every call, as in the JAX package (its solver initializes the
        updater inside each run): with one iteration, every batch is an
        Adam step at t=1. Persistent updater state across batches is the
        data-parallel trainer's (ROADMAP.md queue A item 10)."""
        x, labels = self._input(x), self._input(labels)
        conf = self.conf
        objective = solver_mod.from_loss(
            lambda p: network_loss(conf, p, x, labels, training=True))
        self.params, scores = solver_mod.optimize(
            objective, self.params, conf.conf(conf.n_layers - 1))
        dispatch_listeners(self.listeners, self, scores)

    def _fit_batch(self, x, y) -> None:
        if self.conf.pretrain:
            raise NotImplementedError(
                "layer-wise pretraining is not ported to "
                "deeplearning4j_tpu_torch yet; see ROADMAP.md queue A item 9")
        if self.conf.backprop:
            self.finetune(x, y)

    def fit(self, data, labels=None, *,
            checkpoint_dir: Optional[str] = None) -> None:
        """Train on a DataSet, an (x, y) pair, or an iterator or list of
        them; each batch is one `finetune`."""
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "fit(checkpoint_dir=...) is not ported to "
                "deeplearning4j_tpu_torch yet; see ROADMAP.md queue A item 6")
        if self.params is None:
            self.init()
        batches = [(data, labels)] if labels is not None \
            else _as_batches(data)
        for batch in batches:
            x, y = batch if isinstance(batch, tuple) else (
                batch.features, batch.labels)
            self._fit_batch(x, y)

    def serve(self, host: str = "127.0.0.1", port: int = 0,
              max_delay_ms: Optional[float] = None, max_pending: int = 1024,
              max_batch_rows: Optional[int] = None,
              request_timeout_s: float = 30.0,
              drain_timeout_s: float = 10.0, breaker=None):
        """Start the micro-batching HTTP gateway over this network
        (`serving.ModelServer`): POST /v1/predict, GET /v1/stats, /healthz,
        /readyz. Returns the started server; `server.drain()` stops it."""
        from deeplearning4j_tpu_torch.serving.server import ModelServer

        if self.params is None:
            self.init()
        return ModelServer(self, host=host, port=port,
                           max_delay_ms=max_delay_ms,
                           max_pending=max_pending,
                           max_batch_rows=max_batch_rows,
                           request_timeout_s=request_timeout_s,
                           drain_timeout_s=drain_timeout_s,
                           breaker=breaker).start()


def _as_batches(data):
    """fit() inputs as batches: an iterator of DataSets, one DataSet, a
    list of DataSets or (x, y) pairs, or one (x, y) pair."""
    if hasattr(data, "features") and hasattr(data, "labels"):
        return [(data.features, data.labels)]
    if hasattr(data, "__next__") or hasattr(data, "reset"):
        return ((d.features, d.labels) for d in data)
    if isinstance(data, list):
        return [(d.features, d.labels) if hasattr(d, "features") else d
                for d in data]
    return [data]
