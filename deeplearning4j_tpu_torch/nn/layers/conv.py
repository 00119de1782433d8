"""Convolution and subsampling (pooling) layers.

Counterpart of `deeplearning4j_tpu/nn/layers/conv.py`: NCHW activations,
OIHW filters, symmetric zero padding, VALID pooling windows. The JAX
package convolves with `lax.conv_general_dilated` and pools with
`lax.reduce_window`, outside any Pallas kernel; here the convolution is
cuDNN's (on the CPU, PyTorch's own) and pooling is
`max_pool2d`/`avg_pool2d`, as a large product stays `torch.matmul`.

On CUDA the convolution's forward and both halves of its backward run
under one cuDNN setting of their own (`cudnn_conv_flags`), whatever the
caller's global flags say: no TF32 for f32 operands (the rest of the
port's f32 math has none), deterministic algorithms (so a resumed `fit`
ends bit for bit where an uninterrupted one ends), and no autotuning (the
same algorithm in the eager warm-up and in a captured graph). The backward
is a `torch.autograd.Function` so that the setting reaches it too: autograd
runs it later, outside the forward's call.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nd.ops import activate
from deeplearning4j_tpu_torch.nn.conf import PoolingType
from deeplearning4j_tpu_torch.nn.layers.base import (_sampler, compute_dtype,
                                                     param_dtype)

# the cuDNN flags are process-wide: one lock keeps two threads' conv calls
# from restoring each other's caller flags mid-call
_FLAGS_LOCK = threading.RLock()


@contextlib.contextmanager
def cudnn_conv_flags():
    """cuDNN on, deterministic, TF32 off, autotuning off, for the calls
    inside; the caller's flags are restored after."""
    with _FLAGS_LOCK, torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False):
        yield


def _flags_for(t: torch.Tensor):
    return cudnn_conv_flags() if t.is_cuda else contextlib.nullcontext()


class Conv2dFunction(torch.autograd.Function):
    """`aten.convolution` (no bias, no dilation, one group) whose forward
    and backward run under `cudnn_conv_flags` on CUDA."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.geometry = (list(stride), list(padding))
        with _flags_for(x):
            return torch.ops.aten.convolution(x, w, None, list(stride),
                                              list(padding), [1, 1], False,
                                              [0, 0], 1)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        stride, padding = ctx.geometry
        with _flags_for(grad):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                grad.contiguous(), x, w, None, stride, padding, [1, 1],
                False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


def conv2d(x, w, stride=(1, 1), padding=(0, 0), operand_dtype=None):
    """NCHW convolution: x [B, C, H, W], w [O, C, kh, kw]. Both operands
    are cast to `operand_dtype` (bf16 operands, f32 sums on the card) and
    the result is cast back to w's dtype, as in the JAX package."""
    od = operand_dtype or w.dtype
    out = Conv2dFunction.apply(x.to(od), w.to(od), tuple(stride),
                               tuple(padding))
    return out.to(w.dtype)


def pool2d(x, kind, window=(2, 2), stride=None):
    """MAX, AVG or SUM pooling over NCHW's spatial axes with VALID windows
    (NONE: x itself). AVG is the window sum over kh * kw, as in the JAX
    package."""
    kind = PoolingType(str(kind))
    if kind == PoolingType.NONE:
        return x
    window = tuple(window)
    stride = tuple(stride or window)
    if kind == PoolingType.MAX:
        return F.max_pool2d(x, window, stride)
    s = F.avg_pool2d(x, window, stride, divisor_override=1)
    if kind == PoolingType.SUM:
        return s
    return s / (window[0] * window[1])


class ConvolutionLayer:
    """Conv2d + bias + activation. Params: "W" [O, C, kh, kw], "b" [O]."""

    @staticmethod
    def init(key, conf):
        kh, kw = conf.kernel_size
        shape = (conf.n_out, conf.n_channels, kh, kw)
        d, dev = param_dtype(conf), key.device
        sampler = _sampler(conf)
        if str(conf.weight_init) == "distribution" and sampler is not None:
            W = sampler(key, shape).to(d)
        else:
            # VI/Glorot over the receptive field, not the first two dims
            fan_in = conf.n_channels * kh * kw
            fan_out = conf.n_out * kh * kw
            r = float(np.sqrt(np.float32(6.0 / (fan_in + fan_out))))
            W = nd_random.uniform_dtype(key, shape, d, -r, r)
        return {"W": W, "b": torch.zeros((conf.n_out,), dtype=d, device=dev)}

    @staticmethod
    def forward(params, conf, x, key=None, training=False):
        z = conv2d(x, params["W"], conf.stride, conf.padding,
                   operand_dtype=compute_dtype(conf))
        z = z + params["b"][None, :, None, None]
        return activate(conf.activation, z)


class SubsamplingLayer:
    """Pooling only; no params."""

    @staticmethod
    def init(key, conf):
        return {}

    @staticmethod
    def forward(params, conf, x, key=None, training=False):
        return pool2d(x, conf.pooling, conf.kernel_size, conf.stride)
