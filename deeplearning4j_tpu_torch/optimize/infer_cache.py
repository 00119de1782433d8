"""Captured inference: one CUDA graph per (entry point, conf, bucket).

Counterpart of `deeplearning4j_tpu/optimize/infer_cache.py` for its
single-device f32 entry points `output`, `feed_forward` and `loss`, over
the `CompiledProgramCache` machinery of `optimize/step_cache.py`:

  key schema    (entry point, conf fingerprint, arg shapes/dtypes,
                "single"). `attention_fused_bwd` changes only the backward,
                so it is normalised out of the fingerprint, as in the JAX
                package: flipping it for training re-keys no serving
                program.
  bucketing     a ragged batch pads with zero rows up to the smallest known
                row bucket; `output` and `feed_forward` slice the pad rows
                back off (`truncate_rows`), and `loss` weighs them 0 in a
                weighted mean.
  outputs       a replay overwrites the graph's static outputs, so the
                entry points return copies, made under the pool's lock.
  params        read by address, as the train step writes them, so
                training between two calls is seen by the second.

The decode, prefill, verify and paged entry points come with generation
(ROADMAP.md queue A item 8); the mesh and plan entry points with
parallelism (item 10) and the precision policies with serving-side
optimisation (item 11).
"""

from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch.optimize.step_cache import (CompiledProgramCache,
                                                          arg_signature,
                                                          check_input)


def pad_rows(x: torch.Tensor, bucket: int) -> torch.Tensor:
    """Zero-pad `x` with rows up to `bucket` (feature rows = axis 0)."""
    pad = bucket - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x


def truncate_rows(arr: torch.Tensor, bucket: int, n: int) -> torch.Tensor:
    """A program output cut back to the `n` real input rows. Activations may
    carry `bucket` rows or a whole multiple of it (B*T rows where an
    `rnn_to_ff` preprocessor flattened time into the batch); pad rows take
    the trailing block either way. An output whose leading dim is not tied
    to the batch passes through."""
    if arr.dim() and arr.shape[0] and arr.shape[0] % bucket == 0:
        return arr[: n * (arr.shape[0] // bucket)]
    return arr


class InferCache(CompiledProgramCache):
    """Keyed captured programs for the inference entry points."""

    kind = "infer-cache"

    #: key element of programs made without a mesh (the JAX package's tag)
    SINGLE = "single"

    def _keyed_conf(self, conf):
        if any(c.attention_fused_bwd for c in conf.confs):
            return conf.replace(confs=tuple(
                c.replace(attention_fused_bwd=False) for c in conf.confs))
        return conf

    def output(self, conf, params, x, compile_only: bool = False):
        """`network_output` through the cache: the output activations of the
        `x.shape[0]` real rows (a copy). `compile_only` (warm-up) registers
        the bucket and captures the program without running it."""
        check_input(conf, x)
        n = int(x.shape[0])
        bucket = self.bucket_rows(n)
        xp = pad_rows(x, bucket)
        key = ("output", self._fingerprint(conf), arg_signature(xp),
               self.SINGLE)
        return self._run(key, lambda: _output_program(conf), params, (xp,),
                         read=lambda out: truncate_rows(out, bucket,
                                                        n).clone(),
                         compile_only=compile_only)

    def feed_forward(self, conf, params, x, compile_only: bool = False):
        """`feed_forward` through the cache: the per-layer activations, each
        cut back to the real rows (copies)."""
        check_input(conf, x)
        n = int(x.shape[0])
        bucket = self.bucket_rows(n)
        xp = pad_rows(x, bucket)
        key = ("feed_forward", self._fingerprint(conf), arg_signature(xp),
               self.SINGLE)
        return self._run(key, lambda: _feed_forward_program(conf), params,
                         (xp,),
                         read=lambda acts: [truncate_rows(a, bucket,
                                                          n).clone()
                                            for a in acts],
                         compile_only=compile_only)

    def loss(self, conf, params, x, y, compile_only: bool = False):
        """`network_loss(training=False)` through the cache: the row-weighted
        mean loss over the real rows plus regularization, a 0-d float32
        tensor. Pad rows carry weight 0."""
        check_input(conf, x)
        n = int(x.shape[0])
        bucket = self.bucket_rows(n)
        xp, yp, w = self.pad_batch(x, y, bucket)
        key = ("loss", self._fingerprint(conf), arg_signature(xp, yp, w),
               self.SINGLE)
        return self._run(key, lambda: _loss_program(conf), params,
                         (xp, yp, w), read=lambda s: s.clone(),
                         compile_only=compile_only)


def _output_program(conf) -> Callable:
    # local import: nn.multilayer imports this module at top level
    from deeplearning4j_tpu_torch.nn.multilayer import network_output

    def program(params, x):
        with torch.inference_mode():
            return network_output(conf, params, x)

    return program


def _feed_forward_program(conf) -> Callable:
    from deeplearning4j_tpu_torch.nn.multilayer import feed_forward

    def program(params, x):
        with torch.inference_mode():
            return feed_forward(conf, params, x)

    return program


def _loss_program(conf) -> Callable:
    from deeplearning4j_tpu_torch.nn.multilayer import (network_regularization,
                                                        network_rowwise_loss)

    def program(params, x, y, w):
        with torch.inference_mode():
            rows = network_rowwise_loss(conf, params, x, y, training=False)
            return (torch.dot(rows, w) / torch.clamp(w.sum(), min=1.0)
                    + network_regularization(conf, params))

    return program
