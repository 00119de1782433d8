"""Loss functions: the enum and their math.

Counterpart of `deeplearning4j_tpu/nd/losses.py`. Each loss has a per-row
form (`*_rows`, the last axis reduced) and a batch-mean form; gradients come
from autograd. Every reduction runs in float32 whatever the inputs' dtype,
and logs are taken of probabilities clipped to [1e-7, 1 - 1e-7]. Integer
labels are class ids (sparse): only the mcxent family takes them, and
`mcxent_sparse_rows` gathers the label's probability instead of multiplying
by a one-hot row.
"""

from __future__ import annotations

import enum

import torch

_EPS = 1e-7


class LossFunction(str, enum.Enum):
    MCXENT = "mcxent"                # multi-class cross entropy
    XENT = "xent"                    # binary cross entropy
    MSE = "mse"
    EXPLL = "expll"                  # exponential log-likelihood
    RMSE_XENT = "rmse_xent"
    SQUARED_LOSS = "squared_loss"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    RECONSTRUCTION_CROSSENTROPY = "reconstruction_crossentropy"
    COSINE_PROXIMITY = "cosine_proximity"

    def __str__(self) -> str:
        return self.value


def _clip(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p, _EPS, 1.0 - _EPS)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


# -- per-example forms (last axis reduced; leading axes preserved) ----------

def _is_sparse(labels: torch.Tensor) -> bool:
    """Integer labels are class ids (sparse); floats are dense rows."""
    dt = labels.dtype
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def mcxent_sparse_rows(labels, output):
    """mcxent for integer class-id labels: a gather of each row's label
    probability, equal to `mcxent_rows(one_hot(labels), output)`."""
    picked = _f32(output).gather(-1, labels.long()[..., None])[..., 0]
    return -torch.log(_clip(picked))


def mcxent_rows(labels, output):
    if _is_sparse(labels):
        return mcxent_sparse_rows(labels, output)
    return -torch.sum(_f32(labels) * torch.log(_clip(_f32(output))), dim=-1)


def xent_rows(labels, output):
    y, p = _f32(labels), _clip(_f32(output))
    return -torch.sum(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p),
                      dim=-1)


def mse_rows(labels, output):
    d = _f32(labels) - _f32(output)
    return 0.5 * torch.sum(d * d, dim=-1)


def expll_rows(labels, output):
    p = _clip(_f32(output))
    return torch.sum(p - _f32(labels) * torch.log(p), dim=-1)


def rmse_xent_rows(labels, output):
    d = _f32(labels) - _f32(output)
    return torch.sqrt(torch.sum(d * d, dim=-1) + _EPS)


def squared_loss_rows(labels, output):
    d = _f32(labels) - _f32(output)
    return torch.sum(d * d, dim=-1)


def cosine_proximity_rows(labels, output):
    y, p = _f32(labels), _f32(output)
    yn = y / (torch.linalg.norm(y, dim=-1, keepdim=True) + _EPS)
    pn = p / (torch.linalg.norm(p, dim=-1, keepdim=True) + _EPS)
    return -torch.sum(yn * pn, dim=-1)


_ROWWISE = {
    LossFunction.MCXENT: mcxent_rows,
    LossFunction.XENT: xent_rows,
    LossFunction.MSE: mse_rows,
    LossFunction.EXPLL: expll_rows,
    LossFunction.RMSE_XENT: rmse_xent_rows,
    LossFunction.SQUARED_LOSS: squared_loss_rows,
    LossFunction.NEGATIVELOGLIKELIHOOD: mcxent_rows,
    LossFunction.RECONSTRUCTION_CROSSENTROPY: xent_rows,
    LossFunction.COSINE_PROXIMITY: cosine_proximity_rows,
}

# losses whose rowwise form understands integer class-id labels
_SPARSE_OK = {LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD}


def _checked(lf, base):
    if lf in _SPARSE_OK:
        return base

    def f(labels, output):
        if _is_sparse(labels):
            raise TypeError(
                f"integer (sparse) labels are only supported for "
                f"mcxent-family losses, not {lf}")
        return base(labels, output)

    return f


def get_rowwise(fn):
    """Per-example loss `(labels, output) -> [batch]`."""
    lf = LossFunction(str(fn).lower())
    return _checked(lf, _ROWWISE[lf])


# -- batch-mean forms (the reference's scoring surface) ----------------------

def _mean_of(lf: LossFunction):
    """The batch mean of `lf`'s rowwise form, with its sparse-label
    check."""
    rows = get_rowwise(lf)

    def f(labels, output):
        return torch.mean(rows(labels, output))

    f.__name__ = f.__qualname__ = lf.value
    return f


mcxent = _mean_of(LossFunction.MCXENT)
xent = _mean_of(LossFunction.XENT)
mse = _mean_of(LossFunction.MSE)
expll = _mean_of(LossFunction.EXPLL)
rmse_xent = _mean_of(LossFunction.RMSE_XENT)
squared_loss = _mean_of(LossFunction.SQUARED_LOSS)
negativeloglikelihood = _mean_of(LossFunction.NEGATIVELOGLIKELIHOOD)
reconstruction_crossentropy = _mean_of(
    LossFunction.RECONSTRUCTION_CROSSENTROPY)
cosine_proximity = _mean_of(LossFunction.COSINE_PROXIMITY)

_LOSSES = {
    LossFunction.MCXENT: mcxent,
    LossFunction.XENT: xent,
    LossFunction.MSE: mse,
    LossFunction.EXPLL: expll,
    LossFunction.RMSE_XENT: rmse_xent,
    LossFunction.SQUARED_LOSS: squared_loss,
    LossFunction.NEGATIVELOGLIKELIHOOD: negativeloglikelihood,
    LossFunction.RECONSTRUCTION_CROSSENTROPY: reconstruction_crossentropy,
    LossFunction.COSINE_PROXIMITY: cosine_proximity,
}


def get_loss(fn):
    """Batch-mean loss `(labels, output) -> scalar`."""
    return _LOSSES[LossFunction(str(fn).lower())]


def score(labels, loss_fn, output, l2: float = 0.0, params_l2_norm_sq=None):
    """Scalar score with the optional L2 term `0.5 * l2 * |W|^2`, where
    `params_l2_norm_sq` is the weights' squared norm computed by the
    caller."""
    s = get_loss(loss_fn)(labels, output)
    if l2 and params_l2_norm_sq is not None:
        s = s + 0.5 * l2 * params_l2_norm_sq
    return s
