"""Dense, batch-norm and embedding layers.

Counterpart of `deeplearning4j_tpu/nn/layers/base.py`. A layer is a pair of
plain functions on tensors: `init(key, conf)` returns its params as a dict,
drawn from an int64 [2] threefry key as the JAX package draws them
(keys as in the JAX package), `forward(params, conf, x, key=None,
training=False)` its activations. Under training with a key, a dense
layer drops its input (`conf.dropout`) and its weights (`drop_connect`,
keep 0.5) with the JAX package's threefry masks (`nd/random.py`), after
the same split of its key.

`BatchNormLayer` keeps its running statistics among its params ("ema_*",
with the EMA's total weight "ema_w" for bias correction), as the JAX
package does; the training loop advances them (`nn/multilayer.py`). The
JAX package expresses the batch reductions as gemm contractions
(`rows_broadcast`) so that XLA's results do not depend on zero pad rows
bit for bit; the port reduces with plain sums and broadcasts, which agree
with it to float rounding.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nd.ops import activate
from deeplearning4j_tpu_torch.nn.weights import init_weights

#: a conf's dtype names; "float64" computes in float32, as the JAX package
#: does with x64 disabled
_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


def param_dtype(conf) -> torch.dtype:
    return torch_dtype(conf.dtype)


def compute_dtype(conf) -> torch.dtype:
    cd = getattr(conf, "compute_dtype", "")
    return torch_dtype(cd) if cd else torch_dtype(conf.dtype)


def mixed_matmul(x: torch.Tensor, W: torch.Tensor, conf) -> torch.Tensor:
    """x @ W with both operands in conf.compute_dtype, the product cast
    back to the param dtype (bf16 operands, f32 params)."""
    cd = compute_dtype(conf)
    return (x.to(cd) @ W.to(cd)).to(W.dtype)


def promoted_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in the wider of their dtypes, as JAX promotes a mixed product
    (a float32 input against a serve policy's bfloat16 weights); operands
    of one dtype take the plain product."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def rows_broadcast(v: torch.Tensor, n_rows: int, dtype=None) -> torch.Tensor:
    """A feature vector v[F] over n_rows rows as `ones @ v[None]`, the JAX
    package's rank-1 product: value-equal to a plain broadcast (1.0 * v_j
    is exact), in `dtype` (a torch dtype or a conf's dtype name; None:
    v's). JAX uses it so that the batch reduction of its backward is a
    product whatever the batch; the port's layers broadcast plainly."""
    if dtype is None:
        dt = v.dtype
    elif isinstance(dtype, torch.dtype):
        dt = dtype
    else:
        dt = torch_dtype(dtype)
    ones = torch.ones((n_rows, 1), dtype=dt, device=v.device)
    return ones @ v[None, :].to(dt)


def _sampler(conf):
    return conf.dist.sampler() if conf.dist is not None else None


class DenseLayer:
    """f(x.W + b), with input dropout and drop-connect under training."""

    @staticmethod
    def init(key, conf):
        kw = nd_random.split(key)[0]
        return {
            "W": init_weights(kw, (conf.n_in, conf.n_out), conf.weight_init,
                              _sampler(conf), param_dtype(conf)),
            "b": torch.zeros((conf.n_out,), dtype=param_dtype(conf),
                             device=key.device),
        }

    @staticmethod
    def preout(params, conf, x, key=None, training=False):
        W = params["W"]
        if training and conf.drop_connect and key is not None:
            W = W * nd_random.dropout_mask(key, 0.5, W.shape, W.dtype)
        return mixed_matmul(x, W, conf) + params["b"]

    @staticmethod
    def dropped_input(conf, x, key, training, tp=None):
        """(x with input dropout applied, the drop-connect key): JAX's
        `kdrop, kdc = split(key)`. Under a batch split (`tp.rows`) the
        mask is the global batch's, cut to this rank's rows."""
        if key is None or not training or not (conf.dropout > 0.0
                                                or conf.drop_connect):
            return x, None
        kdrop, kdc = nd_random.split(key)
        if conf.dropout > 0.0:
            x = x * nd_random.dropout_mask(
                kdrop, 1.0 - conf.dropout, x.shape, x.dtype,
                rows=None if tp is None else tp.mask_rows(x.shape[0]))
        return x, kdc

    @staticmethod
    def forward(params, conf, x, key=None, training=False, tp=None):
        x, kdc = DenseLayer.dropped_input(conf, x, key, training, tp)
        return activate(conf.activation,
                        DenseLayer.preout(params, conf, x, kdc, training))


class BatchNormLayer:
    """Batch normalization over the feature axis: the channel axis of NCHW
    input, the last axis otherwise. Training normalizes with the batch's
    statistics (row-weighted where pad rows must not count), inference
    with the bias-corrected running EMA."""

    EPS = 1e-5

    @staticmethod
    def init(key, conf):
        n = conf.n_out or conf.n_in
        d, dev = param_dtype(conf), key.device
        return {
            "gamma": torch.ones((n,), dtype=d, device=dev),
            "beta": torch.zeros((n,), dtype=d, device=dev),
            # raw EMA accumulators and their total weight (1 - m^k):
            # inference divides by ema_w, so one batch already gives exact
            # statistics
            "ema_mean": torch.zeros((n,), dtype=d, device=dev),
            "ema_var": torch.zeros((n,), dtype=d, device=dev),
            "ema_w": torch.zeros((), dtype=d, device=dev),
        }

    @staticmethod
    def _feature_axes(x):
        """The reduction axes: (0, 2, 3) for NCHW, every axis but the last
        otherwise."""
        return (0, 2, 3) if x.dim() == 4 else tuple(range(x.dim() - 1))

    @staticmethod
    def moments(x, row_weights=None):
        """Raw f32 batch moments (s1, s2, cnt) per feature; with
        `row_weights` (one per row of axis 0) each row counts with its
        weight, so pad rows of weight 0 drop out. mean = s1 / cnt, var =
        s2 / cnt - mean^2 (`stats_of`)."""
        axes = BatchNormLayer._feature_axes(x)
        xf = x.float()
        per_row = 1
        for a in axes:
            if a != 0:
                per_row *= x.shape[a]
        if row_weights is None:
            # a fill on the device, not a host copy: a captured step
            # computes it too
            cnt = torch.full((), float(x.shape[0] * per_row),
                             dtype=torch.float32, device=x.device)
            return (xf.sum(dim=axes), (xf * xf).sum(dim=axes), cnt)
        w = row_weights.float().reshape((x.shape[0],) + (1,) * (x.dim() - 1))
        return ((xf * w).sum(dim=axes), (xf * xf * w).sum(dim=axes),
                row_weights.float().sum() * per_row)

    @staticmethod
    def stats_of(s1, s2, cnt):
        """(mean, var) from raw moments."""
        cnt = torch.clamp(cnt, min=1.0)
        mean = s1 / cnt
        var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
        return mean, var

    @staticmethod
    def weighted_batch_stats(x, row_weights):
        """Mean and var over the rows of non-zero weight, in x's dtype."""
        mean, var = BatchNormLayer.stats_of(
            *BatchNormLayer.moments(x, row_weights))
        return mean.to(x.dtype), var.to(x.dtype)

    @staticmethod
    def apply_stats(params, x, mean, var):
        """Normalize x with the given per-feature stats and apply the
        affine."""
        if x.dim() == 4:
            def bc(v):
                return v[None, :, None, None]
        else:
            def bc(v):
                return v
        xn = (x - bc(mean)) / torch.sqrt(bc(var) + BatchNormLayer.EPS)
        return xn * bc(params["gamma"]) + bc(params["beta"])

    @staticmethod
    def forward(params, conf, x, key=None, training=False, row_weights=None):
        axes = BatchNormLayer._feature_axes(x)
        if training and row_weights is not None:
            mean, var = BatchNormLayer.weighted_batch_stats(x, row_weights)
        elif training:
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, unbiased=False)
        else:
            mean, var = params["ema_mean"], params["ema_var"]
            if "ema_w" in params:  # the bias-corrected running estimate
                ema_w = params["ema_w"]
                denom = torch.clamp(ema_w, min=1e-8)
                mean = mean / denom
                # untrained (ema_w == 0): unit variance
                var = torch.where(ema_w > 0, var / denom,
                                  torch.ones_like(var))
        return BatchNormLayer.apply_stats(params, x, mean, var)


def check_ids(ids: torch.Tensor, vocab: int) -> None:
    """Raise ValueError unless every id lies in [0, vocab). On CUDA an
    out-of-range gather index is a device-side assert, which leaves the
    process's CUDA context unusable; the JAX package's gather clamps
    instead."""
    if ids.numel() == 0:
        return
    lo, hi = (int(v) for v in torch.aminmax(ids))
    if lo < 0 or hi >= vocab:
        raise ValueError(f"token ids must lie in [0, {vocab}); got ids "
                         f"from {lo} to {hi}")


_host_checked = threading.local()


@contextlib.contextmanager
def ids_checked():
    """Inside this context `EmbeddingLayer.forward` skips `check_ids`: the
    caller has checked the ids on the host already. The check reads two
    values back to the host, which a CUDA graph cannot hold, so the cached
    entry points (`optimize/step_cache.py`) check their input first and run
    their programs inside it. Per thread."""
    prev = getattr(_host_checked, "on", False)
    _host_checked.on = True
    try:
        yield
    finally:
        _host_checked.on = prev


class EmbeddingLayer:
    """Integer ids -> embedding rows (a gather). With conf.max_seq_len > 0
    a learned positional table "P" is added over the sequence axis. Ids
    outside [0, vocab) raise ValueError (`check_ids`), unless the caller
    checked them already (`ids_checked`)."""

    @staticmethod
    def init(key, conf):
        kw, kp = nd_random.split(key)
        d = param_dtype(conf)
        params = {
            "W": init_weights(kw, (conf.n_in, conf.n_out), conf.weight_init,
                              _sampler(conf), d),
        }
        if conf.max_seq_len > 0:
            # 0.02 * normal in the param dtype, as JAX draws the table
            params["P"] = torch.tensor(0.02, dtype=d, device=key.device) * \
                nd_random.normal_dtype(kp, (conf.max_seq_len, conf.n_out), d)
        return params

    @staticmethod
    def forward(params, conf, x, key=None, training=False):
        ids = x.long()
        if not getattr(_host_checked, "on", False):
            check_ids(ids, params["W"].shape[0])
        e = params["W"][ids]
        if "P" in params and e.dim() >= 2:
            s = e.shape[-2]
            if s > params["P"].shape[0]:
                raise ValueError(
                    f"sequence length {s} exceeds max_seq_len "
                    f"{params['P'].shape[0]}")
            e = e + params["P"][:s]
        return e
