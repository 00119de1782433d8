"""Weight initialisation schemes.

Counterpart of `deeplearning4j_tpu/nn/weights.py`: the same `WeightInit`
names and formulas, drawn from an explicit threefry key with JAX's draws
(`nd/random.py`), so that a seed gives the JAX package's weights, on the
CPU and on the card: bitwise for the uniform schemes, within a few ulps
of float32 (erfinv) for the normal ones.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd import random as nd_random


class WeightInit(str, enum.Enum):
    VI = "vi"
    ZERO = "zero"
    SIZE = "size"
    DISTRIBUTION = "distribution"
    NORMALIZED = "normalized"
    UNIFORM = "uniform"
    XAVIER = "xavier"
    RELU = "relu"
    LECUN = "lecun"

    def __str__(self) -> str:
        return self.value


def _f32(x: float) -> float:
    """x rounded to float32 (JAX's weakly typed scalars)."""
    return float(np.float32(x))


def _sqrt_f32(x: float) -> float:
    """`jnp.sqrt` of a Python float: the float32 root of float32(x)."""
    return float(np.sqrt(np.float32(x)))


def init_weights(key: torch.Tensor, shape: Sequence[int],
                 scheme=WeightInit.VI,
                 distribution: Optional[Callable] = None,
                 dtype=torch.float32) -> torch.Tensor:
    """A weight tensor of `shape` under the named scheme, drawn from `key`
    (an int64 [2] threefry key) on the key's device, as the JAX package
    draws it: NORMALIZED and VI scale a float32 uniform, then cast;
    UNIFORM, SIZE and XAVIER draw a uniform in `dtype` between their
    bounds; RELU and LECUN scale a float32 normal, then cast.

    `distribution`, used by DISTRIBUTION, is a callable `(key, shape) ->
    tensor` (see `nn.conf.Distribution.sampler`).
    """
    shape = tuple(int(s) for s in shape)
    scheme = WeightInit(str(scheme).lower())
    fan_in = shape[0] if shape else 1
    fan_out = shape[1] if len(shape) > 1 else shape[0] if shape else 1

    if scheme == WeightInit.ZERO:
        return torch.zeros(shape, dtype=dtype, device=key.device)
    if scheme == WeightInit.NORMALIZED:
        return ((nd_random.uniform_dtype(key, shape) - 0.5)
                / fan_in).to(dtype)
    if scheme == WeightInit.UNIFORM:
        a = 1.0 / fan_in
        return nd_random.uniform_dtype(key, shape, dtype, -a, a)
    if scheme == WeightInit.VI:
        r = _f32(np.float32(_sqrt_f32(6.0)) / np.float32(
            _sqrt_f32(sum(shape) + 1.0)))
        return (nd_random.uniform_dtype(key, shape) * 2.0 * r
                - r).to(dtype)
    if scheme in (WeightInit.SIZE, WeightInit.XAVIER):
        r = _sqrt_f32(6.0 / (fan_in + fan_out))
        return nd_random.uniform_dtype(key, shape, dtype, -r, r)
    if scheme == WeightInit.RELU:
        return (nd_random.normal_dtype(key, shape)
                * _sqrt_f32(2.0 / fan_in)).to(dtype)
    if scheme == WeightInit.LECUN:
        return (nd_random.normal_dtype(key, shape)
                * _sqrt_f32(1.0 / fan_in)).to(dtype)
    if scheme == WeightInit.DISTRIBUTION:
        if distribution is None:
            raise ValueError("WeightInit.DISTRIBUTION requires a distribution")
        return distribution(key, shape).to(dtype)
    raise ValueError(f"unknown weight init scheme {scheme}")
