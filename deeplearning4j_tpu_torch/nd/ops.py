"""Elementwise activation registry, with derivatives.

Counterpart of `deeplearning4j_tpu/nd/ops.py`: the same `Activation` names,
registered to PyTorch functions; `register_activation` adds one by name,
and `activation_derivative` gives any registered activation's elementwise
derivative by autograd (softmax: the diagonal term `y * (1 - y)`, as in the
JAX package). Two choices follow JAX's defaults so the port computes what
the reference computes: `gelu` is the tanh approximation (`jax.nn.gelu`
defaults to `approximate=True`) and `leakyrelu` has slope 0.01.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict

import torch
import torch.nn.functional as F


class Activation(str, enum.Enum):
    """Activation names understood by layer configs."""

    SIGMOID = "sigmoid"
    TANH = "tanh"
    RELU = "relu"
    LEAKY_RELU = "leakyrelu"
    SOFTMAX = "softmax"
    SOFTPLUS = "softplus"
    LINEAR = "linear"
    IDENTITY = "identity"
    HARD_TANH = "hardtanh"
    EXP = "exp"
    ELU = "elu"
    GELU = "gelu"

    def __str__(self) -> str:  # so configs serialize to the bare name
        return self.value


_REGISTRY: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    # JAX's forms, so the derivative at a kink is JAX's too: leakyrelu's
    # slope at 0 is 1, and hardtanh's at +-1 is 1/2 (a tie of max or min
    # splits the gradient)
    "leakyrelu": lambda x: torch.where(x >= 0, x, 0.01 * x),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "softplus": F.softplus,
    "linear": lambda x: x,
    "identity": lambda x: x,
    "hardtanh": lambda x: torch.minimum(torch.maximum(
        x, torch.full_like(x, -1.0)), torch.full_like(x, 1.0)),
    "exp": torch.exp,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def register_activation(name: str,
                        fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
    """Register a named elementwise activation (a known name is
    replaced)."""
    _REGISTRY[str(name).lower()] = fn


def get_activation(name) -> Callable[[torch.Tensor], torch.Tensor]:
    key = str(name).lower()
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown activation '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def activate(name, x: torch.Tensor) -> torch.Tensor:
    return get_activation(name)(x)


def activation_derivative(name, x: torch.Tensor) -> torch.Tensor:
    """The elementwise derivative of the named activation at `x`. Softmax,
    which is not elementwise, gives the diagonal of its Jacobian, `y * (1 -
    y)`; every other activation is differentiated by autograd (a ones
    cotangent through the function), so a registered one needs no formula.
    Works inside `torch.inference_mode` too."""
    fn = get_activation(name)
    if str(name).lower() == "softmax":
        y = fn(x)
        return y * (1.0 - y)
    with torch.inference_mode(False), torch.enable_grad():
        xg = x.detach().clone().requires_grad_(True)
        y = fn(xg)
        (dx,) = torch.autograd.grad(y, xg, torch.ones_like(y))
    return dx
