"""MultiLayerNetwork: a configuration plus a tuple of per-layer params.

Counterpart of `deeplearning4j_tpu/nn/multilayer.py`: `init_params`,
`feed_forward`, `network_output`, the losses (`network_loss`,
`network_rowwise_loss`, `make_finetune_loss`, `network_regularization`),
and `MultiLayerNetwork` with `init` / `output` / `feed_forward` /
`predict` / `score` / `evaluate` / `fit` / `warmup` / `warmup_generate` /
`serve`, and the flat parameter vector (`params_flat`, `set_params_flat`,
written in place) and `clone` (on copies). Params are a
tuple of dicts of tensors with the JAX package's key names, so
`parallel/checkpoint.py` carries weights both ways.
Gradients come from autograd through the plain forward.

As in the JAX package, `finetune` (so `fit`) runs through the network's
`step_cache` and `output` / `feed_forward` / `score` of batched input
through its `infer_cache`: on CUDA one captured CUDA graph per (entry
point, conf, bucket), replayed (`optimize/step_cache.py`,
`optimize/infer_cache.py`). A graph reads the params by address, so the
train step writes its result into the param tensors in place, and
assigning another params tree drops the network's graphs.
`use_step_cache=False` / `use_infer_cache=False` give the eager paths.
`fit(checkpoint_dir=...)` is crash-safe and resumable, as in the JAX
package.

Keys: the network holds the JAX package's threefry key stream
(`prng_key(seed)`, split on the host as two ints): `init` draws the params
from one key as JAX does (`init_params`, so a seed gives JAX's params on
the CPU and on the card) and each `finetune` another, which the solver
splits once an iteration and the losses into one key a layer, so dropout
and drop-connect draw JAX's masks. A conf that drops nothing (`uses_key`)
gets no key on the device and splits nothing. The checkpoint saves the key as
`metadata["rng_key"]`, JAX's name.

BatchNorm: the cached step trains on row-weighted batch moments (pad rows
weigh 0) and advances the running EMA inside the captured graph from the
last live iteration's moments, written into the EMA leaves in place, so
the inference graphs read the new EMA; the eager path advances it after
the step with one more forward (`update_bn_ema`), as JAX's uncached path
does.

Serving precision (`set_serve_precision`, the JAX package's): "f32",
"bf16" or "int8" for every later `output` / `feed_forward` / `score`, every
generation program and every program `warmup` captures
(`optimize/quantize.py`); int8 quantizes a snapshot of the params, with
its clip calibrated on a held-out batch, and with a store attached
(`set_compile_cache`, or `DL4J_COMPILE_CACHE` at construction) the
quantized weights are kept there under (conf fingerprint, params digest),
so that another process loads them instead of calibrating. A train step
writes the params in place and tells the infer cache
(`InferCache.params_written`), so the bf16 cast follows training.

Pretraining: with `conf.pretrain`, each `fit` batch first trains every
pretrainable hidden layer (RBM, autoencoder) in order on its own input
(the batch fed forward through the layers below it and its preprocessor)
with that layer's solver (`pretrain_layer`: through `step_cache.pretrain`,
the layer's params written in place), then finetunes. Each pretrainable
layer takes the stream's next key whether or not it draws, so the stream
advances as JAX's does; only a layer that draws (an RBM, an autoencoder
with corruption) gets it on the device.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nd.platform import resolve_device
from deeplearning4j_tpu_torch.nd.losses import get_loss
from deeplearning4j_tpu_torch.nn.conf import (LayerType,
                                              MultiLayerConfiguration,
                                              OptimizationAlgorithm)
from deeplearning4j_tpu_torch.nn.layers import get_layer
from deeplearning4j_tpu_torch.nn.layers.base import BatchNormLayer
from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
from deeplearning4j_tpu_torch.nn.layers.preprocessor import apply_preprocessor
from deeplearning4j_tpu_torch.optimize import solver as solver_mod
from deeplearning4j_tpu_torch.optimize import step_cache as step_cache_mod
from deeplearning4j_tpu_torch.optimize.infer_cache import InferCache
from deeplearning4j_tpu_torch.optimize.listeners import \
    dispatch as dispatch_listeners
from deeplearning4j_tpu_torch.optimize.step_cache import (GraphPool,
                                                          TrainStepCache)
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves
from deeplearning4j_tpu_torch.reliability import TrainingInterrupted

log = logging.getLogger("deeplearning4j_tpu_torch")

#: the layer types that layer-wise pretraining trains
_PRETRAINABLE = {LayerType.RBM, LayerType.AUTOENCODER,
                 LayerType.RECURSIVE_AUTOENCODER}


def init_params(conf: MultiLayerConfiguration, key: torch.Tensor) -> tuple:
    """Every layer's params from `key` (an int64 [2] threefry key, on the
    device the params go to), JAX's `split(key, max(1, n_layers))`, one
    key a layer. A leaf is drawn at a time, so the draws' temporaries are
    one leaf's."""
    keys = nd_random.split(key, max(1, conf.n_layers))
    return tuple(get_layer(c.layer_type).init(keys[i], c)
                 for i, c in enumerate(conf.confs))


def uses_key(conf: MultiLayerConfiguration) -> bool:
    """Whether a training forward of `conf` draws from its key: a layer
    with dropout or drop-connect. Without one the key changes no value,
    so the callers leave it off the device and split nothing."""
    return any(c.dropout > 0.0 or c.drop_connect for c in conf.confs)


def _layer_keys(key, n: int) -> list:
    """`n` keys, one a layer, JAX's `split(key, n)`; Nones without a
    key."""
    if key is None:
        return [None] * n
    ks = nd_random.split(key, n)
    return [ks[i] for i in range(n)]


def _is_bn(c) -> bool:
    return LayerType(str(c.layer_type)) == LayerType.BATCH_NORM


#: the layer types that take the model axis (`tp`): the attention and FFN
#: blocks split by head and hidden unit, the dense and output layers only
#: cut the global batch's dropout mask to this rank's rows
_TP_TYPES = {LayerType.ATTENTION, LayerType.TRANSFORMER_FFN,
             LayerType.DENSE, LayerType.OUTPUT}


def _forward(c, p, x, key, training, tp):
    """One layer's forward; `tp` reaches the layers of `_TP_TYPES`."""
    layer = get_layer(c.layer_type)
    if tp is not None and LayerType(str(c.layer_type)) in _TP_TYPES:
        return layer.forward(p, c, x, key, training, tp=tp)
    return layer.forward(p, c, x, key, training)


def feed_forward(conf: MultiLayerConfiguration, params, x, key=None,
                 training: bool = False, up_to: Optional[int] = None,
                 tp=None) -> list:
    """Activations after each layer; `up_to` stops early. `tp` (a
    `parallel.tensor.TensorParallel`) is the model axis: the params are
    this rank's shards of it (`tp_layout`), and the activations come out
    whole on every model rank."""
    n = conf.n_layers if up_to is None else up_to
    keys = _layer_keys(key, max(1, n))
    acts = []
    for i in range(n):
        c = conf.conf(i)
        x = apply_preprocessor(conf.preprocessor(i), x)
        x = _forward(c, params[i], x, keys[i], training, tp)
        acts.append(x)
    return acts


def network_output(conf: MultiLayerConfiguration, params, x, key=None,
                   training: bool = False, tp=None):
    acts = feed_forward(conf, params, x, key, training, tp=tp)
    return acts[-1] if acts else x


def network_loss(conf: MultiLayerConfiguration, params, x, labels, key=None,
                 training: bool = True):
    """End-to-end loss: hidden forward + the output layer's scored loss,
    plus 0.5 * l2 * |W|^2 of every hidden layer when the output layer
    regularizes. Under training a BatchNorm layer normalizes with the
    batch's statistics, and with a key the layers drop as configured."""
    n = conf.n_layers
    keys = _layer_keys(key, n)
    h = x
    for i in range(n - 1):
        c = conf.conf(i)
        h = apply_preprocessor(conf.preprocessor(i), h)
        h = get_layer(c.layer_type).forward(params[i], c, h, keys[i],
                                            training)
    out_conf = conf.conf(n - 1)
    h = apply_preprocessor(conf.preprocessor(n - 1), h)
    loss = OutputLayer.loss(params[n - 1], out_conf, h, labels, keys[n - 1],
                            training)
    if out_conf.use_regularization and out_conf.l2:
        for i in range(n - 1):
            if "W" in params[i]:
                loss = loss + 0.5 * out_conf.l2 * torch.sum(
                    params[i]["W"].float() ** 2)
    return loss


def network_rowwise_loss(conf: MultiLayerConfiguration, params, x, labels,
                         key=None, training: bool = True, row_weights=None,
                         return_bn_stats: bool = False, tp=None):
    """Per-label-row loss vector, no regularization (see
    `network_regularization`). Rows follow `labels`' leading dim, e.g.
    B*T for a sequence model whose `rnn_to_ff` flattens time.

    `row_weights` (one per feature row, pad rows 0) keeps a training
    BatchNorm layer's statistics to the real rows. `return_bn_stats` also
    returns the raw moments ((s1, s2, cnt) per BatchNorm layer, in layer
    order) of this forward, from which the train step advances the running
    EMA without a second forward (`update_bn_ema_from_stats`). `tp`: the
    model axis, as in `feed_forward`."""
    n = conf.n_layers
    keys = _layer_keys(key, n)
    h = x
    stats = []
    for i in range(n - 1):
        c = conf.conf(i)
        h = apply_preprocessor(conf.preprocessor(i), h)
        if _is_bn(c) and training and (row_weights is not None
                                       or return_bn_stats):
            s1, s2, cnt = BatchNormLayer.moments(h, row_weights)
            if return_bn_stats:
                stats.append((s1, s2, cnt))
            mean, var = BatchNormLayer.stats_of(s1, s2, cnt)
            h = BatchNormLayer.apply_stats(params[i], h, mean.to(h.dtype),
                                           var.to(h.dtype))
        else:
            h = _forward(c, params[i], h, keys[i], training, tp)
    h = apply_preprocessor(conf.preprocessor(n - 1), h)
    rows = OutputLayer.rowwise_loss(params[n - 1], conf.conf(n - 1), h,
                                    labels, keys[n - 1], training, tp)
    if return_bn_stats:
        return rows, tuple(stats)
    return rows


def has_batchnorm(conf: MultiLayerConfiguration) -> bool:
    return any(_is_bn(c) for c in conf.confs)


def _bn_ema_apply(c, p, mean, var):
    """One layer's EMA advance: ema = m * ema + (1 - m) * batch, and the
    EMA's total weight for bias correction."""
    m = c.batch_norm_momentum
    p = dict(p)
    p["ema_mean"] = (m * p["ema_mean"].float()
                     + (1 - m) * mean).to(p["ema_mean"].dtype)
    p["ema_var"] = (m * p["ema_var"].float()
                    + (1 - m) * var).to(p["ema_var"].dtype)
    if "ema_w" in p:
        p["ema_w"] = (m * p["ema_w"].float() + (1 - m)).to(p["ema_w"].dtype)
    return p


def update_bn_ema_from_stats(conf: MultiLayerConfiguration, params, stats,
                             group=None):
    """Every BatchNorm layer's running stats advanced from the raw moments
    the loss forward computed (`network_rowwise_loss(...,
    return_bn_stats=True)`): a new params tree. With a process `group`
    (the data-parallel step's) the moments s1, s2 and cnt are first summed
    over its ranks in one all-reduce, so every rank records the global
    batch's statistics, as the JAX package's `psum` over the mesh axis
    does."""
    bn_idx = [i for i, c in enumerate(conf.confs) if _is_bn(c)]
    if group is not None and stats:
        import torch.distributed as dist

        leaves = [t for moments in stats for t in moments]
        packed = torch.cat([t.reshape(-1).float() for t in leaves])
        dist.all_reduce(packed, group=group)
        parts = torch.split(packed, [t.numel() for t in leaves])
        it = iter(p.view(t.shape).to(t.dtype) for p, t in zip(parts, leaves))
        stats = tuple((next(it), next(it), next(it)) for _ in stats)
    new = list(params)
    for (s1, s2, cnt), i in zip(stats, bn_idx):
        mean, var = BatchNormLayer.stats_of(s1, s2, cnt)
        new[i] = _bn_ema_apply(conf.conf(i), new[i], mean, var)
    return tuple(new)


def update_bn_ema(conf: MultiLayerConfiguration, params, x,
                  row_weights=None):
    """Every BatchNorm layer's running stats advanced from one batch by a
    forward up to the last BatchNorm layer (training statistics all the
    way, row-weighted with `row_weights`): the eager path's EMA, after the
    step. Returns a new params tree."""
    if not has_batchnorm(conf):
        return params
    last_bn = max(i for i, c in enumerate(conf.confs) if _is_bn(c))
    new = list(params)
    h = x
    with torch.no_grad():
        for i in range(last_bn + 1):
            c = conf.conf(i)
            h = apply_preprocessor(conf.preprocessor(i), h)
            if _is_bn(c):
                mean, var = BatchNormLayer.stats_of(
                    *BatchNormLayer.moments(h, row_weights))
                new[i] = _bn_ema_apply(c, new[i], mean, var)
            if i < last_bn:
                if _is_bn(c):
                    h = BatchNormLayer.forward(params[i], c, h, None,
                                               training=True,
                                               row_weights=row_weights)
                else:
                    h = get_layer(c.layer_type).forward(params[i], c, h,
                                                        None, True)
    return tuple(new)


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


def make_finetune_loss(conf: MultiLayerConfiguration,
                       collect_bn: bool = False):
    """Row-weighted loss `(params, x, y, w, key) -> (loss, stats)`: the
    w-weighted mean of `network_rowwise_loss` over the rows whose weight is
    not 0, plus `network_regularization`. w is one weight per label row
    (padding rows carry 0); the feature rows weigh what their first label
    row weighs, so BatchNorm layers train on the real rows' moments. stats
    is () unless `collect_bn` (then this forward's raw BatchNorm moments,
    for `update_bn_ema_from_stats`)."""

    def loss_fn(params, x, y, w, key=None):
        ratio = w.shape[0] // x.shape[0]
        wx = w.reshape(x.shape[0], ratio)[:, 0]
        out = network_rowwise_loss(conf, params, x, y, key, training=True,
                                   row_weights=wx,
                                   return_bn_stats=collect_bn)
        rows, stats = out if collect_bn else (out, ())
        loss = (torch.dot(rows, w) / torch.clamp(w.sum(), min=1.0)
                + network_regularization(conf, params))
        return loss, stats

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
        # JAX's key stream, as two uint32 ints (`_next_key`)
        self._key = (0, self.seed & 0xFFFFFFFF)
        # one captured program per (conf, algorithm, bucket) for the train
        # step, and per (entry point, conf, bucket) for inference, in one
        # memory pool; use_*_cache=False runs the eager paths
        pool = GraphPool()
        self.step_cache = TrainStepCache(pool=pool)
        self.use_step_cache = True
        self.infer_cache = InferCache(pool=pool)
        self.use_infer_cache = True
        self._params: Optional[tuple] = None
        self.listeners: List = []
        # set by SIGTERM or request_stop_training; fit(checkpoint_dir=...)
        # checks it between batches
        self._stop_training = threading.Event()
        # crash-resume books, reported by the CLI's train JSON
        self.resumed_from_batch: Optional[int] = None
        self.checkpoint_write_seconds = 0.0
        self.checkpoints_written = 0
        # did the last finetune advance the BatchNorm EMA in its step?
        self._bn_in_step = False
        # the serve-precision report of the active policy
        # (`set_serve_precision`)
        self._serve_precision_report: dict = {"policy": "f32"}
        # DL4J_COMPILE_CACHE=<dir> attaches the persistent store to every
        # network of the process, as the CLI's --compile-cache does to one
        cache_dir = os.environ.get("DL4J_COMPILE_CACHE")
        if cache_dir:
            self.set_compile_cache(cache_dir)

    @property
    def params(self) -> Optional[tuple]:
        return self._params

    @params.setter
    def params(self, value) -> None:
        """Assign a params tree. The network's CUDA graphs read the tensors
        they were captured with, so a tree of other tensors drops them (the
        next call captures anew)."""
        old, self._params = self._params, value
        self.infer_cache.params_written()
        if old is None or value is old:
            return
        new_leaves = tree_leaves(value) if value is not None else []
        old_leaves = tree_leaves(old)
        if len(new_leaves) != len(old_leaves) or any(
                a is not b for a, b in zip(new_leaves, old_leaves)):
            self.step_cache.drop_graphs()
            self.infer_cache.drop_graphs()

    def _next_key(self) -> tuple:
        """The next key of the stream, JAX's `self._key, sub =
        split(self._key)`: two ints."""
        self._key, sub = nd_random.split_host(self._key)
        return sub

    def _key_tensor(self, key):
        """A stream key as the int64 [2] tensor the solver splits, on the
        network's device; None where the conf draws nothing from it."""
        if not uses_key(self.conf):
            return None
        return torch.tensor(key, dtype=torch.int64, device=self.device)

    def init(self) -> "MultiLayerNetwork":
        key = torch.tensor(self._next_key(), dtype=torch.int64,
                           device=self.device)
        self.params = init_params(self.conf, key)
        return self

    def params_written(self) -> None:
        """Note that the params were written in place (the train steps and
        `set_params_flat` call it): a cast serve policy casts again."""
        self.infer_cache.params_written()

    # -- the persistent store and the serve precision -----------------------
    def set_compile_cache(self, directory, max_bytes=None, remote=None):
        """Attach a persistent store at `directory` (`optimize/persist.py`)
        to both caches: the int8 weight artifact, the continuous batcher's
        prefix entries and the tuned table (`optimize/tunables.py`, installed
        here when none is active) go through it. A CUDA graph is not written
        to disk, so every process captures its own programs. `remote` (a
        `serving.cachesync.CacheFetcher`) serves the entries the directory
        lacks (`PersistentProgramStore.set_remote`). Returns the store."""
        from deeplearning4j_tpu_torch.optimize.persist import \
            PersistentProgramStore

        kw = {} if max_bytes is None else {"max_bytes": max_bytes}
        store = PersistentProgramStore(directory, device=self.device, **kw)
        if remote is not None:
            # before the table's lookup below, so that a table this
            # directory lacks is fetched too
            store.set_remote(remote)
        self.step_cache.set_persist(store)
        self.infer_cache.set_persist(store)
        # tuned-table inheritance: a table `cli tune` stored for this (conf
        # fingerprint, device kind) installs process-wide here, so replicas
        # and later sessions serve with the tuned constants and
        # fresh_tunes == 0; a missing, corrupt or other-kind table leaves
        # the registry defaults (inside load_and_install)
        from deeplearning4j_tpu_torch.optimize import tunables
        from deeplearning4j_tpu_torch.optimize.step_cache import \
            conf_fingerprint

        if tunables.active() is None:
            tunables.load_and_install(store, conf_fingerprint(self.conf))
        return store

    @property
    def serve_precision(self) -> str:
        """The active serve-path precision policy ("f32" until set)."""
        return self.infer_cache.policy

    @property
    def serve_precision_report(self) -> dict:
        """The report `set_serve_precision` gave for the active policy."""
        return self._serve_precision_report

    def set_serve_precision(self, policy: str = "f32", calibration=None,
                            measure: bool = True) -> dict:
        """Serve every later call under `policy` (`optimize/quantize.py`):
        "f32" (bitwise the pre-policy path), "bf16" (params cast once,
        bfloat16 compute) or "int8" (per-channel symmetric weights, the
        clip calibrated on `calibration`, a held-out batch; None is
        `default_calibration`). The policy is a key element, so the
        programs of each coexist. int8 quantizes a snapshot of the params;
        call this again after training to quantize anew. With a store
        attached, the quantized weights are looked up there under
        `quantize_artifact_key` (a hit calibrates nothing; a corrupt entry
        is evicted and calibrated again) and written after a calibration.

        Returns, and keeps as `serve_precision_report`, {"policy"}, the
        calibration report (int8), where the artifact came from and the
        seconds it took ("artifact": {"source": "disk" or "calibrated",
        "seconds"}), and unless `measure` is False the accuracy delta
        against f32 on a held-out batch (`quantize.accuracy_delta`)."""
        from deeplearning4j_tpu_torch.optimize import quantize

        quantize.validate_policy(policy)
        if self.params is None:
            self.init()
        qparams = cal_report = artifact = None
        if policy == "int8":
            if calibration is None:
                calibration = quantize.default_calibration(self.conf)
            calibration = self._input(calibration)
            t0 = time.perf_counter()
            store = self.infer_cache.persist
            blob = None
            if store is not None:
                art_key = quantize.quantize_artifact_key(
                    self.infer_cache._fingerprint(self.conf),
                    quantize.params_digest(self.params))
                blob = store.load_bytes(art_key)
            if blob is not None:
                try:
                    qparams, cal_report = quantize.unpack_quantized(
                        blob, self.device)
                    artifact = "disk"
                except Exception:  # noqa: BLE001 — calibrate instead
                    qparams = None
            if qparams is None:
                qparams, cal_report = quantize.calibrate_int8(
                    self.conf, self.params, calibration)
                artifact = "calibrated"
                if store is not None:
                    store.store_bytes(
                        art_key, quantize.pack_quantized(qparams, cal_report))
            artifact = {"source": artifact,
                        "seconds": time.perf_counter() - t0}
        self.infer_cache.set_policy(policy, qparams=qparams)
        report = {"policy": policy}
        if cal_report:
            report["calibration"] = cal_report
            report["artifact"] = artifact
        if measure and policy != "f32":
            # held out from the calibration batch when that defaulted
            batch = (calibration if calibration is not None
                     else quantize.default_calibration(self.conf, seed=1))
            report["accuracy_delta"] = quantize.accuracy_delta(
                self.conf, self.params, self._input(batch), policy,
                qparams=self.infer_cache._qparams if policy == "int8"
                else None)
        self._serve_precision_report = report
        return report

    def set_serve_mesh(self, mesh=None, spec=None):
        """Serve over a mesh of ranks, the JAX package's contract: no
        arguments is the 1-D ("batch",) mesh over every rank
        (`parallel/mesh.serve_mesh`: rows split, params whole); `spec` a
        `--mesh` value ("batch=2,model=4"; "" or "all" the 1-D mesh), whose
        model axis splits heads, FFN units and the decode state's K/V
        columns (`parallel/plan.plan_mesh`); `mesh` a mesh made already.
        `mesh` and `spec` exclude each other. Every rank calls it, with
        the network on the mesh's device; then rank 0 serves and the
        others `follow`. Programs of each mesh are keyed by its plan and
        coexist. Returns the mesh."""
        from deeplearning4j_tpu_torch.parallel.mesh import serve_mesh
        from deeplearning4j_tpu_torch.parallel.plan import (parse_mesh_spec,
                                                            plan_mesh)

        if mesh is not None and spec is not None:
            raise ValueError("pass mesh= or spec=, not both")
        if spec is not None:
            mesh = plan_mesh(parse_mesh_spec(spec), device=self.device)
        elif mesh is None:
            mesh = serve_mesh(device=self.device)
        if mesh.device != self.device:
            raise ValueError(f"the mesh's device {mesh.device} is not the "
                             f"network's {self.device}: build the network "
                             f"on the mesh's device")
        self.infer_cache.set_mesh(mesh)
        return mesh

    def follow(self) -> int:
        """On a rank other than 0 of the serving mesh: run rank 0's calls
        until it stops them (`stop_followers`); returns how many ran."""
        return self.infer_cache.follow(self)

    def stop_followers(self) -> None:
        """On rank 0 of the serving mesh: end the other ranks' `follow`."""
        self.infer_cache.stop_followers()

    def set_listeners(self, listeners) -> None:
        self.listeners = list(listeners)

    def _input(self, x) -> torch.Tensor:
        """Features or labels as a tensor on the network's device (float64
        becomes float32)."""
        x = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x)
        # the guard that keeps float64 off the device: it names the dtype
        if x.dtype == torch.float64:  # lint: allow(f64-literal)
            x = x.float()
        return x.to(self.device)

    def check_input(self, x) -> None:
        """Raise ValueError, on the host, for input the first layer cannot
        take: token ids outside [0, vocab) for an embedding. The batcher
        calls it per request, so one bad request neither reaches the
        device nor fails the batch it would have joined."""
        step_cache_mod.check_input(self.conf, np.asarray(x) if not isinstance(
            x, torch.Tensor) else x)

    def warmup(self, shapes, entries=("output",), train: bool = False):
        """Capture the serve (and with `train`, train) programs for the
        given batch shapes ahead of traffic, so that the first real call is
        a hit. `shapes`: batch sizes (int: (b, n_in) zeros), full input
        shapes (tuple: zeros) or example arrays. The zeros are float32,
        or int32 ids where the first layer is an embedding: the JAX package
        warms float32 there, a program its int32 requests never hit
        (ROADMAP.md, reference faults). `entries`: "output", "feed_forward",
        "loss". Labels for "loss" and the train step are zeros: int32 class
        ids where the output layer's conf has `sparse_labels`, else shaped
        and typed like the network's output. Returns the shapes, the
        entries and both caches' stats."""
        if self.params is None:
            self.init()
        captured = []
        ids = (LayerType(str(self.conf.confs[0].layer_type))
               == LayerType.EMBEDDING)
        dtype = torch.int32 if ids else torch.float32
        for spec in shapes:
            if isinstance(spec, int):
                x = torch.zeros((spec, self.conf.confs[0].n_in), dtype=dtype,
                                device=self.device)
            elif isinstance(spec, tuple):
                x = torch.zeros(spec, dtype=dtype, device=self.device)
            else:
                x = self._input(spec)
            y = None
            if train or "loss" in entries:
                with torch.no_grad():
                    out = network_output(self.conf, self.params, x)
                out_conf = self.conf.conf(self.conf.n_layers - 1)
                # int class ids where the conf trains on them, else rows
                # like the output
                y = (torch.zeros(out.shape[:-1], dtype=torch.int32,
                                 device=self.device)
                     if out_conf.sparse_labels else torch.zeros_like(out))
            for entry in entries:
                if entry == "output":
                    self.infer_cache.output(self.conf, self.params, x,
                                            compile_only=True)
                elif entry == "feed_forward":
                    self.infer_cache.feed_forward(self.conf, self.params, x,
                                                  compile_only=True)
                elif entry == "loss":
                    self.infer_cache.loss(self.conf, self.params, x, y,
                                          compile_only=True)
                else:
                    raise ValueError(f"unknown warmup entry {entry!r}")
            if train:
                self.step_cache.finetune(self.conf, self.params, x, y,
                                         self._key_tensor(self._key),
                                         compile_only=True)
            captured.append(tuple(x.shape))
        return {"shapes": captured, "entries": list(entries),
                "train": bool(train),
                "step_cache": self.step_cache.stats.as_dict(),
                "infer_cache": self.infer_cache.stats.as_dict()}

    def warmup_generate(self, slots: Optional[int] = None, max_seq: int = 64,
                        prompt_buckets=(8,), page_size: Optional[int] = None,
                        n_pages: int = 0, prefix_cache: bool = False,
                        draft_net=None, spec_k: int = 0,
                        steps_per_dispatch: Optional[int] = None):
        """Capture the generation programs a `ContinuousBatcher` of the same
        options runs, ahead of traffic, on the states it decodes in
        (`InferCache.decode_state`): the one-step decode over the
        `slots`-wide table (over the page pool with `page_size` > 0), every
        K of the ladder up to `steps_per_dispatch` (a ramp dispatches each
        of them, K = 1 included), and one B = 1 prefill per prompt bucket
        (`prefill_logp` under `prefix_cache`); with `draft_net` and
        `spec_k`, also the `spec_k`-token verify (`verify_paged` with
        `page_size` > 0) and, on the draft's own states, its one-step
        decode over the table and one prefill per prompt bucket. So
        `fresh_compiles` stays 0 under traffic. The options a batcher
        refuses raise here too. Returns the geometry and the infer cache's
        stats."""
        from deeplearning4j_tpu_torch.serving.batcher import (
            decode_geometry, decode_k_ladder)

        geo = decode_geometry(slots, max_seq, page_size, n_pages,
                              steps_per_dispatch, draft_net, spec_k)
        if self.params is None:
            self.init()
        slots, ps, k_max = geo["slots"], geo["page_size"], geo["k_max"]
        spec_k = geo["spec_k"]
        ic, dev = self.infer_cache, self.device
        zeros = torch.zeros((slots,), dtype=torch.int32, device=dev)
        keys = torch.zeros((slots, 2), dtype=torch.int64, device=dev)
        temps = torch.zeros((slots,), device=dev)
        ladder = decode_k_ladder(k_max) if k_max > 1 else ()
        if ps > 0:
            table = ic.decode_state(self.conf, slots, max_seq, dev, "pool",
                                    pages=(geo["n_pages"] + 1, ps))
            page_table = torch.zeros((slots, geo["pages_per_slot"]),
                                     dtype=torch.int32, device=dev)
            ic.decode_paged(self.conf, self.params, table, zeros, zeros,
                            keys, temps, page_table, compile_only=True)
            for k in ladder:
                ic.decode_multi_paged(self.conf, self.params, table, zeros,
                                      zeros, keys, temps, zeros, page_table,
                                      k, compile_only=True)
        else:
            table = ic.decode_state(self.conf, slots, max_seq, dev, "table")
            ic.decode(self.conf, self.params, table, zeros, zeros, keys,
                      temps, compile_only=True)
            for k in ladder:
                ic.decode_multi(self.conf, self.params, table, zeros, zeros,
                                keys, temps, zeros, k, compile_only=True)
        if draft_net is not None:
            toks = torch.zeros((slots, spec_k), dtype=torch.int32,
                               device=dev)
            if ps > 0:
                ic.verify_paged(self.conf, self.params, table, toks, zeros,
                                keys, temps, page_table, compile_only=True)
            else:
                ic.verify(self.conf, self.params, table, toks, zeros, keys,
                          temps, compile_only=True)
            dn, dic = draft_net, draft_net.infer_cache
            dn_table = dic.decode_state(dn.conf, slots, max_seq, dn.device,
                                        "draft")
            dic.decode(dn.conf, dn.params, dn_table, zeros, zeros, keys,
                       temps, compile_only=True)
            dn_row = dic.decode_state(dn.conf, 1, max_seq, dn.device,
                                      "draft-row")
        row = ic.decode_state(self.conf, 1, max_seq, dev, "row")
        buckets = sorted(int(b) for b in prompt_buckets)
        for tb in buckets:
            if tb > max_seq:
                raise ValueError(f"prompt bucket {tb} exceeds "
                                 f"max_seq={max_seq}")
            prompt = torch.zeros((1, tb), dtype=torch.int32, device=dev)
            length = torch.ones((1,), dtype=torch.int32, device=dev)
            if prefix_cache:
                ic.prefill_logp(self.conf, self.params, row, prompt, length,
                                compile_only=True)
            else:
                ic.prefill(self.conf, self.params, row, prompt, length,
                           keys[:1], temps[:1], compile_only=True)
            if draft_net is not None:
                dic.prefill(dn.conf, dn.params, dn_row, prompt, length,
                            keys[:1], temps[:1], compile_only=True)
        return {"slots": slots, "max_seq": int(max_seq),
                "prompt_buckets": buckets, "page_size": ps,
                "prefix_cache": bool(prefix_cache), "spec_k": spec_k,
                "steps_per_dispatch": k_max,
                "infer_cache": ic.stats.as_dict()}

    # -- inference -----------------------------------------------------------
    def _serve_cached(self, x: torch.Tensor) -> bool:
        """Batched input (axis 0 = rows, which buckets pad) with the cache
        on."""
        return self.use_infer_cache and x.dim() >= 2

    def feed_forward(self, x) -> list:
        """Every layer's activations on `x`."""
        x = self._input(x)
        with torch.inference_mode():
            if self._serve_cached(x):
                return self.infer_cache.feed_forward(self.conf, self.params,
                                                     x)
            return feed_forward(self.conf, self.params, x)

    def output(self, x) -> torch.Tensor:
        """The network's output on `x`, as a tensor on the network's
        device."""
        x = self._input(x)
        with torch.inference_mode():
            if self._serve_cached(x):
                return self.infer_cache.output(self.conf, self.params, x)
            return network_output(self.conf, self.params, x)

    def predict(self, x) -> np.ndarray:
        return self.output(x).argmax(dim=-1).cpu().numpy()

    def score(self, x, labels) -> float:
        """The network's loss on (x, labels), regularization included."""
        x, labels = self._input(x), self._input(labels)
        with torch.inference_mode():
            if self._serve_cached(x):
                return float(self.infer_cache.loss(self.conf, self.params, x,
                                                   labels))
            return float(network_loss(self.conf, self.params, x, labels,
                                      training=False))

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
    def _finetune_objective(self, x, labels):
        """The eager finetune's objective: `network_loss` by autograd; for
        Hessian-free also the Gauss-Newton product of the network's output
        and the output layer's loss (JAX's R-operator replacement)."""
        conf = self.conf
        objective = solver_mod.from_loss(
            lambda p, k: network_loss(conf, p, x, labels, k, training=True),
            with_key=True)
        out_conf = conf.conf(conf.n_layers - 1)
        if (OptimizationAlgorithm(str(out_conf.optimization_algo))
                == OptimizationAlgorithm.HESSIAN_FREE):
            solver_mod.check_jvp(conf, x.is_cuda)
            loss_fn = get_loss(out_conf.loss_function)
            objective = objective._replace(
                gnvp=solver_mod.from_predict_loss(
                    lambda p, k: network_output(conf, p, x),
                    lambda z: loss_fn(labels, z)).gnvp)
        return objective

    def pretrain_layer(self, i: int, x) -> None:
        """Train layer i's unsupervised objective on its own input x with
        the layer's solver, on the stream's next key: through
        `step_cache.pretrain` (params written in place) or eagerly."""
        c = self.conf.conf(i)
        impl = get_layer(c.layer_type)
        x = self._input(x)
        key = self._next_key()
        key = (torch.tensor(key, dtype=torch.int64, device=self.device)
               if impl.uses_key(c) else None)
        if self.use_step_cache:
            scores = self.step_cache.pretrain(c, i, impl, self.params[i], x,
                                              key)
            self.params_written()
        else:
            new, scores = solver_mod.optimize(
                step_cache_mod.pretrain_objective(c, impl, x),
                self.params[i], c, key)
            params = list(self.params)
            params[i] = new
            self.params = tuple(params)
        dispatch_listeners(self.listeners, self, scores)

    def pretrain(self, data) -> None:
        """Layer-wise pretraining of every pretrainable hidden layer, batch
        by batch: layer i trains on the batch fed forward through layers
        below it (inference mode), then its preprocessor."""
        for batch in _as_batches(data):
            x = self._input(batch[0] if isinstance(batch, tuple) else batch)
            for i in range(self.conf.n_layers - 1):
                c = self.conf.conf(i)
                if LayerType(str(c.layer_type)) not in _PRETRAINABLE:
                    continue
                with torch.no_grad():
                    acts = feed_forward(self.conf, self.params, x, up_to=i)
                    layer_in = apply_preprocessor(self.conf.preprocessor(i),
                                                  acts[-1] if acts else x)
                self.pretrain_layer(i, layer_in)

    def finetune(self, x, labels) -> None:
        """Supervised end-to-end optimization of the loss on one batch with
        the output layer's solver, on the stream's next key: through
        `step_cache` by default (the row-weighted loss, the batch padded to
        its bucket, the BatchNorm EMA advanced in the step; on CUDA one
        captured graph replayed), else eagerly on `network_loss`. The
        updater state starts at zero on every call, as in the JAX package
        (its solver initializes the updater inside each run): with one
        iteration, every batch is an Adam step at t=1. Persistent updater
        state across batches is the data-parallel trainer's
        (`parallel/data_parallel.py`)."""
        x, labels = self._input(x), self._input(labels)
        conf = self.conf
        key = self._key_tensor(self._next_key())
        if self.use_step_cache:
            scores = self.step_cache.finetune(conf, self.params, x, labels,
                                              key)
            self.params_written()
            self._bn_in_step = has_batchnorm(conf)
        else:
            self.params, scores = solver_mod.optimize(
                self._finetune_objective(x, labels), self.params,
                conf.conf(conf.n_layers - 1), key)
            self._bn_in_step = False
        dispatch_listeners(self.listeners, self, scores)

    def _fit_batch(self, x, y) -> None:
        self._bn_in_step = False
        if self.conf.pretrain:
            self.pretrain(self._input(x))
        if self.conf.backprop:
            self.finetune(x, y)
        if has_batchnorm(self.conf) and not self._bn_in_step:
            # the eager path: the running EMA from one more forward with
            # the new params, as JAX's uncached path computes it
            self.params = update_bn_ema(self.conf, self.params,
                                        self._input(x))

    def fit(self, data, labels=None, *,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every_n_batches: int = 0,
            auto_resume: bool = True) -> None:
        """Train on a DataSet, an (x, y) pair, or an iterator or list of
        them; each batch is layer-wise pretraining (a `pretrain` conf),
        then one `finetune` (a `backprop` conf).

        With `checkpoint_dir` the run is crash-safe, as in the JAX package:
        params, the key stream and the batch cursor are checkpointed
        atomically every `checkpoint_every_n_batches` batches (0: never in
        between) and at the end; a SIGTERM (handled on the main thread) or
        `request_stop_training` checkpoints after the current batch and
        raises `TrainingInterrupted`; and a rerun with the same directory
        and the same batch stream resumes at the saved cursor
        (`auto_resume`), reaching the params of one uninterrupted run. The
        updater restarts on every batch, so params and the key are all the
        state there is."""
        if self.params is None:
            self.init()
        batches = [(data, labels)] if labels is not None \
            else _as_batches(data)
        if checkpoint_dir is None:
            for batch in batches:
                self._fit_batch(*_pair(batch))
            return
        self._fit_checkpointed(batches, checkpoint_dir,
                               int(checkpoint_every_n_batches), auto_resume)

    def request_stop_training(self) -> None:
        """Ask a running `fit(checkpoint_dir=...)` to checkpoint and raise
        `TrainingInterrupted` after the current batch (what the installed
        SIGTERM handler calls)."""
        self._stop_training.set()

    def _save_checkpoint(self, directory: str, batches_done: int) -> None:
        from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt

        t0 = time.perf_counter()
        # the key under JAX's own name, which JAX's resume reads too
        meta = {"rng_key": [int(v) for v in self._key]}
        ckpt.save(directory, self.params, conf=self.conf, step=batches_done,
                  data_cursor={"batches_done": int(batches_done)},
                  metadata=meta)
        self.checkpoint_write_seconds += time.perf_counter() - t0
        self.checkpoints_written += 1

    def _fit_checkpointed(self, batches, checkpoint_dir: str, every_n: int,
                          auto_resume: bool) -> None:
        from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt

        start_batch = 0
        if auto_resume:
            restored = ckpt.load_resilient(checkpoint_dir,
                                           like_params=self.params)
            if restored is not None:
                params, _, meta = restored
                self.params = params
                start_batch = int(
                    (meta.get("data_cursor") or {}).get("batches_done", 0))
                # a "torch_generator_state" of older checkpoints is not
                # read: no generator draws anything
                rng = (meta.get("metadata") or {}).get("rng_key")
                if rng is not None:
                    self._key = tuple(int(v) & 0xFFFFFFFF for v in rng)
                self.resumed_from_batch = start_batch
                log.info("fit: auto-resumed %s at batch %d", checkpoint_dir,
                         start_batch)
        self._stop_training.clear()
        prev_handler, installed = None, False
        if threading.current_thread() is threading.main_thread():
            try:
                prev_handler = signal.signal(
                    signal.SIGTERM,
                    lambda signum, frame: self._stop_training.set())
                installed = True
            except ValueError:
                pass  # an embedding without signals: explicit stop only
        n_done = 0
        try:
            for batch in batches:
                n_done += 1
                if n_done <= start_batch:
                    continue  # replaying the resumed prefix of the stream
                self._fit_batch(*_pair(batch))
                if self._stop_training.is_set():
                    self._save_checkpoint(checkpoint_dir, n_done)
                    raise TrainingInterrupted(
                        f"stop requested: checkpointed {checkpoint_dir} at "
                        f"batch {n_done}")
                if every_n > 0 and n_done % every_n == 0:
                    self._save_checkpoint(checkpoint_dir, n_done)
            self._save_checkpoint(checkpoint_dir, n_done)
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev_handler)

    # -- the parameter vector ------------------------------------------------
    def params_flat(self) -> torch.Tensor:
        """Every param in one 1-D tensor, in the order and dtype of the JAX
        package's `ravel_pytree`: layer by layer, each layer's names sorted,
        promoted to their common dtype."""
        leaves = tree_leaves(self.params)
        dtype = leaves[0].dtype
        for t in leaves[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
        return torch.cat([t.detach().reshape(-1).to(dtype) for t in leaves])

    def set_params_flat(self, flat) -> None:
        """Write a `params_flat` vector back into the param tensors, in
        place (each leaf takes its own dtype back). The CUDA graphs read the
        params by address, so they stay valid: the next step replays."""
        flat = torch.as_tensor(flat).reshape(-1)
        leaves = tree_leaves(self.params)
        n = sum(t.numel() for t in leaves)
        if flat.numel() != n:
            raise ValueError(f"flat params have {flat.numel()} elements; the "
                             f"network has {n}")
        flat = flat.to(leaves[0].device)
        offset = 0
        with torch.no_grad():
            for t in leaves:
                t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()
        self.params_written()

    def clone(self) -> "MultiLayerNetwork":
        """A network of the same conf and device on copies of the params.
        The JAX package's clone shares its (immutable) arrays; here the
        train step writes params in place, so sharing them would train the
        clone with the original."""
        net = MultiLayerNetwork(self.conf, device=self.device,
                                seed=self.seed)
        if self.params is not None:
            net.params = tuple({k: v.detach().clone() for k, v in
                                layer.items()} for layer in self.params)
        return net

    def serve(self, host: str = "127.0.0.1", port: int = 0,
              max_delay_ms: Optional[float] = None, max_pending: int = 1024,
              max_batch_rows: Optional[int] = None, batching: bool = True,
              request_timeout_s: float = 30.0,
              drain_timeout_s: float = 10.0, default_deadline_ms=None,
              breaker=None,
              generate: bool = False, gen_slots: Optional[int] = None,
              gen_max_seq: int = 64, gen_prompt_buckets=(8,),
              gen_max_pending: int = 64,
              gen_page_size: Optional[int] = None, gen_pages: int = 0,
              gen_prefix_cache: bool = False,
              gen_prefix_match: str = "exact",
              gen_draft=None, gen_spec_k: int = 0,
              gen_steps_per_dispatch: Optional[int] = None):
        """Start the micro-batching HTTP gateway over this network
        (`serving.ModelServer`): POST /v1/predict, GET /v1/stats, /healthz,
        /readyz, and with `generate` POST /v1/generate through a
        `ContinuousBatcher` of `gen_slots` slots (its options the `gen_*`
        arguments). `batching=False` answers each predict with its own
        `output` call; `default_deadline_ms` is the deadline of a request
        that names none. Call `warmup` first so the first request replays a
        captured graph. Returns the started server; `server.drain()` stops
        it."""
        from deeplearning4j_tpu_torch.serving.server import ModelServer

        if self.params is None:
            self.init()
        return ModelServer(self, host=host, port=port,
                           max_delay_ms=max_delay_ms,
                           max_pending=max_pending,
                           max_batch_rows=max_batch_rows,
                           batching=batching,
                           request_timeout_s=request_timeout_s,
                           drain_timeout_s=drain_timeout_s,
                           default_deadline_ms=default_deadline_ms,
                           breaker=breaker, generate=generate,
                           gen_slots=gen_slots, gen_max_seq=gen_max_seq,
                           gen_prompt_buckets=gen_prompt_buckets,
                           gen_max_pending=gen_max_pending,
                           gen_page_size=gen_page_size, gen_pages=gen_pages,
                           gen_prefix_cache=gen_prefix_cache,
                           gen_prefix_match=gen_prefix_match,
                           gen_draft=gen_draft, gen_spec_k=gen_spec_k,
                           gen_steps_per_dispatch=gen_steps_per_dispatch
                           ).start()


def _pair(batch):
    """(x, y) of a batch: an (x, y) tuple or a DataSet."""
    return batch if isinstance(batch, tuple) else (batch.features,
                                                   batch.labels)


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
