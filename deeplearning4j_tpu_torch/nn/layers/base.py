"""Dense and embedding layers.

Counterpart of `deeplearning4j_tpu/nn/layers/base.py`. A layer is a pair of
plain functions on tensors: `init(gen, conf)` returns its params as a dict
(keys as in the JAX package), `forward(params, conf, x)` its activations.
This slice ports inference; dropout and dropconnect come with training.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from deeplearning4j_tpu_torch.nd.ops import activate
from deeplearning4j_tpu_torch.nn.weights import init_weights

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
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


def _sampler(conf):
    return conf.dist.sampler() if conf.dist is not None else None


class DenseLayer:
    """f(x.W + b)."""

    @staticmethod
    def init(gen, conf):
        return {
            "W": init_weights(gen, (conf.n_in, conf.n_out), conf.weight_init,
                              _sampler(conf), param_dtype(conf)),
            "b": torch.zeros((conf.n_out,), dtype=param_dtype(conf),
                             device=gen.device),
        }

    @staticmethod
    def preout(params, conf, x):
        return mixed_matmul(x, params["W"], conf) + params["b"]

    @staticmethod
    def forward(params, conf, x):
        return activate(conf.activation, DenseLayer.preout(params, conf, x))


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
    def init(gen, conf):
        params = {
            "W": init_weights(gen, (conf.n_in, conf.n_out), conf.weight_init,
                              _sampler(conf), param_dtype(conf)),
        }
        if conf.max_seq_len > 0:
            params["P"] = 0.02 * torch.randn(
                (conf.max_seq_len, conf.n_out), generator=gen,
                device=gen.device).to(param_dtype(conf))
        return params

    @staticmethod
    def forward(params, conf, x):
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
