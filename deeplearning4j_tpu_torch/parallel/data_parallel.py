"""Data-parallel training over a `torch.distributed` process group.

Counterpart of `deeplearning4j_tpu/parallel/data_parallel.py`. The JAX
package compiles one `shard_map` program over every device of its mesh;
the port runs one process per rank (`parallel/mesh.py`), each on its
contiguous shard of the batch, and the collectives of the JAX program
become `torch.distributed` calls inside each rank's step:

  sync        each rank takes its shard's gradient, one all-reduce (SUM)
              over the flat gradient buffer of `optimize/updater.py`'s
              `FlatSpec` (one a dtype group) and one over the score, a
              division by n (JAX's `pmean` is `psum / n`; gloo has no
              AVG), then the updater chain. At world size 1 the
              all-reduce still runs, in place.
  masked      the pad-and-mask step of remainder batches: per-label-row
              weights w (pad rows 0), den = max(psum(sum w), 1), loss =
              sum(rows * w) / den + regularization / n, and the SUMs are
              not divided.
  grad_accum  k microbatches a shard, one update from the mean of their
              gradients; each microbatch takes the next split of the key.
  averaging   BSP: `local_steps` updater steps on each rank's own shard,
              then params and updater state averaged (masked: weighted by
              each rank's real rows, a rank of pad rows only gated out).
  zero1       ZeRO-1: the flat gradient is reduce-scattered, each rank
              steps its chunk of the flat updater state (1/n of it), and
              the params are all-gathered back. The JAX package shards
              each leaf's first divisible dim; the port chunks the flat
              buffer (ROADMAP.md queue C).

The trainer's state lives in flat buffers, one a dtype group: the params
(`TrainState.params` is a tree of views into them, a copy of the
network's), the updater's two moments, and the step counter on the host.
The updater persists across batches, so the iteration's host constants
(`updater.iteration_constants`: Adam's bias corrections, the scheduled
momentum, AdaGrad's reset) enter each step as a float32 input. The
trainer's steps are programs of a `DPStepCache` (kind "dp-step-cache"):
on CUDA one captured graph per (variant, shapes), the collectives inside
it, the state written in place; on the CPU, or with the cache's `capture`
off, the same program runs eagerly.

The per-rank dropout key is `fold_in(key, rank)`, as in the JAX package.
BatchNorm layers normalise with each shard's own moments, and the sync
step advances the running EMA from the moments summed over the ranks
(`update_bn_ema_from_stats(..., group=)`); the averaging round advances
it from local moments and averages it with the params.

`DataParallelTrainer` drives a `MultiLayerNetwork` as the JAX package's
does: `fit` over batches (remainders padded and masked), listeners, the
`trainer.step` fault point, crash-safe and elastic checkpoints (params,
updater, step, key and batch cursor; a checkpoint of n ranks resumes on
m), and at the end the trained params copied into the network's own
tensors in place, so its inference graphs stay valid.

Tensor parallelism (`plan=`, a `parallel.plan.ShardPlan` with a model
axis): the JAX package's one GSPMD program becomes each rank's part of
it. Rank (b, m) holds its shards of the attention and FFN blocks
(`parallel/tensor.py`'s layout; every other leaf whole), runs the
forward and backward on its rows of the batch with the model axis's
collectives inside the layers, all-reduces the gradient over the batch
axis only (ZeRO-1: reduce-scatters it and all-gathers the params, the
sync step's chunks of this rank's own flat buffers), takes the batch
axis's mean
score, and draws the dropout masks of the whole batch from the unfolded
key, keeping its rows. `plan_params_from_numpy` carries the JAX package's
params in as this rank's shards; checkpoints take the sharded layout
(`checkpoint.save_sharded`) and resume on any layout; at the end of `fit`
the network's params are gathered whole on every rank.
"""

from __future__ import annotations

import logging
import math
import signal
import threading
import time
from typing import Callable, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                    has_batchnorm,
                                                    network_regularization,
                                                    network_rowwise_loss,
                                                    update_bn_ema_from_stats,
                                                    uses_key)
from deeplearning4j_tpu_torch.nn.layers.base import ids_checked
from deeplearning4j_tpu_torch.optimize.solver import _grads
from deeplearning4j_tpu_torch.optimize.step_cache import (DPStepCache,
                                                          check_input)
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves, tree_map
from deeplearning4j_tpu_torch.optimize.updater import (FlatSpec,
                                                       UpdaterState,
                                                       adjust_gradient_flat,
                                                       flat_ravel,
                                                       flat_unravel,
                                                       iteration_constants,
                                                       make_flat_spec)
from deeplearning4j_tpu_torch.parallel.mesh import (Mesh, batch_tensor,
                                                    shard_batch)
from deeplearning4j_tpu_torch.parallel.tensor import (  # noqa: F401
    CAPTURED_COLLECTIVES, TensorParallel, all_gather, all_reduce,
    reduce_scatter, shard_leaf, tp_layout, unshard_leaf)
from deeplearning4j_tpu_torch.reliability import TrainingInterrupted, faults

log = logging.getLogger("deeplearning4j_tpu_torch")


# -- state -------------------------------------------------------------------

class FlatState(NamedTuple):
    """The buffers a trainer's state lives in, one a dtype group of
    `spec`: the params (padded to n·chunk under ZeRO-1), and the updater's
    AdaGrad history (Adam's second moment) and velocity (its first),
    whole, or this rank's chunk under ZeRO-1 (`chunk`: per group its
    length, else None)."""

    spec: FlatSpec
    params: tuple
    hist: tuple
    vel: tuple
    chunk: Optional[tuple] = None


class TrainState(NamedTuple):
    """Params, updater state and the step counter (the JAX package's
    `TrainState`). `params` is a tree of views into `flat.params`;
    `updater` holds trees of views into the updater buffers, or under
    ZeRO-1 this rank's flat chunks; `step` counts on the host."""

    params: object
    updater: UpdaterState
    step: int
    flat: Optional[FlatState] = None


def _padded(buf: torch.Tensor, size: int) -> torch.Tensor:
    if buf.numel() == size:
        return buf
    return torch.cat([buf, buf.new_zeros(size - buf.numel())])


def _state_from_trees(params, updater: Optional[UpdaterState], step: int,
                      n: int = 1, rank: int = 0,
                      zero1: bool = False) -> TrainState:
    """A TrainState over new flat buffers holding copies of `params` and
    `updater` (zeros when None); under ZeRO-1 the updater keeps this
    rank's chunk only."""
    spec = make_flat_spec(params)
    chunk = (tuple(-(-s // n) for s in spec.group_sizes) if zero1
             else None)
    sizes = (tuple(c * n for c in chunk) if zero1 else spec.group_sizes)
    with torch.no_grad():
        pbufs = tuple(_padded(b.detach().clone(), size) for b, size in
                      zip(flat_ravel(spec, params), sizes))
        if updater is None:
            hist = tuple(torch.zeros_like(b) for b in pbufs)
            vel = tuple(torch.zeros_like(b) for b in pbufs)
        else:
            hist = tuple(_padded(b.clone(), size) for b, size in zip(
                flat_ravel(spec, updater.adagrad_hist), sizes))
            vel = tuple(_padded(b.clone(), size) for b, size in zip(
                flat_ravel(spec, updater.velocity), sizes))
        if zero1:
            hist = tuple(b[rank * c:(rank + 1) * c].clone()
                         for b, c in zip(hist, chunk))
            vel = tuple(b[rank * c:(rank + 1) * c].clone()
                        for b, c in zip(vel, chunk))
    flat = FlatState(spec, pbufs, hist, vel, chunk)
    return TrainState(params=flat_unravel(spec, pbufs),
                      updater=_updater_view(flat), step=int(step), flat=flat)


def _updater_view(flat: FlatState) -> UpdaterState:
    if flat.chunk is not None:
        return UpdaterState(adagrad_hist=flat.hist, velocity=flat.vel)
    return UpdaterState(adagrad_hist=flat_unravel(flat.spec, flat.hist),
                        velocity=flat_unravel(flat.spec, flat.vel))


def init_train_state(net: MultiLayerNetwork) -> TrainState:
    """A TrainState on a copy of the network's params (the train steps
    write the state in place), zero updater state and step 0."""
    if net.params is None:
        net.init()
    return _state_from_trees(net.params, None, 0)


def zero1_shard_state(state: TrainState, mesh: Mesh,
                      axis: str = "dp") -> TrainState:
    """Place a TrainState for the ZeRO-1 step: params whole (their buffers
    padded to n chunks), the updater's flat buffers cut into n chunks of
    which this rank keeps its own (1/n of the updater's memory)."""
    n = mesh.shape[axis]
    updater = gather_updater(state, mesh, axis)
    return _state_from_trees(state.params, updater, state.step, n,
                             _rank(mesh, axis), zero1=True)


def gather_updater(state: TrainState, mesh: Mesh,
                   axis: str = "dp") -> UpdaterState:
    """The whole updater state as trees: under ZeRO-1 every rank's chunk
    gathered (a collective: every rank calls it), else the state's own
    trees."""
    flat = state.flat
    if flat.chunk is None:
        return state.updater
    group, n = mesh.axis_group(axis), mesh.shape[axis]

    def full(chunks):
        bufs = []
        for b, c, size in zip(chunks, flat.chunk, flat.spec.group_sizes):
            out = b.new_empty(c * n)
            all_gather(out, b, group)
            bufs.append(out[:size])
        return flat_unravel(flat.spec, bufs)

    return UpdaterState(adagrad_hist=full(flat.hist),
                        velocity=full(flat.vel))


def _rank(mesh: Mesh, axis: str = "dp") -> int:
    return mesh.coord(axis)


def _feature_row_weights(w, x):
    """Per-feature-row weights from a per-label-row mask (label rows may be
    a multiple of feature rows, e.g. B*T for sequence models)."""
    ratio = w.shape[0] // x.shape[0]
    return w.reshape(x.shape[0], ratio)[:, 0]


# -- collectives ------------------------------------------------------------

def _scalar_sum(t: torch.Tensor, group) -> torch.Tensor:
    """psum of a scalar: the all-reduce of a one-element copy."""
    return all_reduce(t.float().reshape(1).clone(), group).reshape(())


# -- the steps --------------------------------------------------------------

def _split_inputs(rest, masked: bool):
    """(w, consts, key) from the inputs after (x, y)."""
    w = rest[0] if masked else None
    rest = rest[1:] if masked else rest
    return w, rest[0], (rest[1] if len(rest) > 1 else None)


def _loss_fn(conf, x, y, w, den, n: int, collect_bn: bool,
             dot: bool = False, tp=None):
    """`(params, key) -> (loss, BatchNorm moments)` of one shard: the mean
    of the rows plus regularization, or with weights w the weighted sum
    over the global `den` plus regularization / n (every rank's loss sums
    to the global one)."""
    wx = None if w is None else _feature_row_weights(w, x)

    def loss(p, k):
        out = network_rowwise_loss(conf, p, x, y, k, training=True,
                                   row_weights=wx,
                                   return_bn_stats=collect_bn, tp=tp)
        rows, stats = out if collect_bn else (out, ())
        if w is None:
            return rows.mean() + network_regularization(conf, p), stats
        total = torch.dot(rows, w) if dot else torch.sum(rows * w)
        return (total / den + network_regularization(conf, p) / n,
                stats)

    return loss


def _write_ema(spec: FlatSpec, bufs, conf, stats, group) -> None:
    """Advance the BatchNorm EMA leaves of the params in `bufs` (fresh
    buffers of the step's result) from the moments, in place."""
    tree = flat_unravel(spec, bufs)
    new = update_bn_ema_from_stats(conf, tree, stats, group=group)
    for old_layer, new_layer in zip(tree, new):
        for name, t in old_layer.items():
            if new_layer[name] is not t:
                t.copy_(new_layer[name])


def _accum_grads(conf, spec, params, x, y, key, k: int):
    """Flat gradient and score of the mean of k microbatch losses, each on
    the next split of the key (JAX's microbatch scan)."""
    xs = x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))
    ys = y.reshape((k, y.shape[0] // k) + tuple(y.shape[1:]))
    acc, score = None, None
    for m in range(k):
        sub = None
        if key is not None:
            key, sub = nd_random.split(key)
        loss = _loss_fn(conf, xs[m], ys[m], None, None, 1, False)
        g, s, _ = _grads(loss, params, sub)
        g = flat_ravel(spec, g)
        acc = g if acc is None else tuple(a + b for a, b in zip(acc, g))
        score = s if score is None else score + s
    return tuple(a / k for a in acc), score / k


def _shard_key(key, rank: int, n: int, rows: int,
               tp: Optional[TensorParallel]):
    """(the dropout key of this rank's shard, the model axis as its layers
    see it). Data parallel: the batch key folded with the rank, distinct
    masks a shard and the same update everywhere. Under a model axis: the
    batch key itself, each rank taking its rows of the global batch's one
    draw, as the JAX package's one program draws it."""
    if tp is None:
        return (None if key is None else nd_random.fold_in(key, rank)), None
    return key, tp.with_rows(rank * rows, rows, n * rows)


def _plan_norm(flat: FlatState, chunk, rank: int, n: int, group,
               tp: Optional[TensorParallel]):
    """The norm of `_sharded_norm` for a step on `flat`'s buffers, a leaf
    split over `tp`'s model axis summed over its group."""
    split = () if tp is None else [
        tp.is_split(i, name)
        for i, name in _leaf_names(flat_unravel(flat.spec, flat.params))]
    return _sharded_norm(flat.spec, chunk, rank, n, group, split, tp)


def _sync_program(conf, mesh: Mesh, axis: str, masked: bool,
                  grad_accum: int, flat: FlatState,
                  tp: Optional[TensorParallel] = None) -> Callable:
    """The sync (or masked, or grad_accum) step: a function of (bufs, x,
    y, [w], consts, [key]) returning the new buffers and the score. With
    `tp` (`make_plan_train_step`) the forward and backward run on this
    rank's shards with the model axis's collectives inside them, the
    gradient is all-reduced over the batch group (`axis`) only, and the
    norms sum a split leaf over the model group."""
    out_conf = conf.conf(conf.n_layers - 1)
    collect_bn = has_batchnorm(conf)
    n, group = mesh.shape[axis], mesh.axis_group(axis)
    rank = _rank(mesh, axis)
    spec = flat.spec
    norm = None if tp is None else _plan_norm(flat, None, rank, n, group, tp)

    def compute(bufs, x, y, *rest):
        pbufs, hbufs, vbufs = bufs
        w, consts, key = _split_inputs(rest, masked)
        params = flat_unravel(spec, pbufs)
        k, shard_tp = _shard_key(key, rank, n, x.shape[0], tp)
        stats = ()
        if grad_accum > 1:
            gbufs, score = _accum_grads(conf, spec, params, x, y, k,
                                        grad_accum)
        else:
            den = None
            if w is not None:
                den = torch.clamp(_scalar_sum(w.sum(), group), min=1.0)
            loss = _loss_fn(conf, x, y, w, den, n, collect_bn,
                            dot=tp is not None, tp=shard_tp)
            grads, score, stats = _grads(loss, params, k)
            gbufs = flat_ravel(spec, grads)
        # the all-reduce: what the reference moved as whole param vectors
        for g in gbufs:
            all_reduce(g, group)
        score = _scalar_sum(score, group)
        if w is None and n > 1:
            gbufs = tuple(g / n for g in gbufs)
            score = score / n
        adj, upd = adjust_gradient_flat(out_conf, 0, gbufs, pbufs,
                                        UpdaterState(hbufs, vbufs), spec,
                                        consts=consts, norm_fn=norm)
        new = tuple(p - a.to(p.dtype) for p, a in zip(pbufs, adj))
        if collect_bn:
            # running inference stats from the global batch's moments
            _write_ema(spec, new, conf, stats, group)
        return new, upd.adagrad_hist, upd.velocity, score

    return compute


def _write_state(bufs, out) -> torch.Tensor:
    """Copy a step's new buffers into the state's, in place; the score."""
    new, hist, vel, score = out
    for dst, src in zip(tree_leaves(bufs), tree_leaves((new, hist, vel))):
        dst.copy_(src)
    return score


def _averaging_program(conf, mesh: Mesh, axis: str, masked: bool,
                       local_steps: int, spec: FlatSpec) -> Callable:
    """One BSP round: `local_steps` updater steps on this rank's shard,
    then params and updater state averaged over the ranks."""
    out_conf = conf.conf(conf.n_layers - 1)
    collect_bn = has_batchnorm(conf)
    n, group = mesh.shape[axis], mesh.axis_group(axis)
    rank = _rank(mesh, axis)

    def compute(bufs, x, y, *rest):
        pbufs, hbufs, vbufs = bufs
        w, consts, key = _split_inputs(rest, masked)
        k = None if key is None else nd_random.fold_in(key, rank)
        if w is not None:
            local_den = w.sum()
            safe_den = torch.clamp(local_den, min=1.0)
            has_data = (local_den > 0).float()
        loss = _loss_fn(conf, x, y, w, None if w is None else safe_den, 1,
                        collect_bn)
        p, h, v = pbufs, hbufs, vbufs
        for it in range(local_steps):
            sub = None
            if k is not None:
                k, sub = nd_random.split(k)
            grads, score, stats = _grads(loss, flat_unravel(spec, p), sub)
            adj, (h, v) = adjust_gradient_flat(
                out_conf, 0, flat_ravel(spec, grads), p, UpdaterState(h, v),
                spec, consts=consts[it])
            if w is None:
                p = tuple(q - a.to(q.dtype) for q, a in zip(p, adj))
            else:
                p = tuple(q - has_data * a.to(q.dtype)
                          for q, a in zip(p, adj))
            if collect_bn:
                # local moments: the average below takes the EMA along
                _write_ema(spec, p, conf, stats, None)
        trees = tuple(p) + tuple(h) + tuple(v)
        if w is None:
            for t in trees:
                all_reduce(t, group)
            score = _scalar_sum(score, group)
            if n > 1:
                trees = tuple(t / n for t in trees)
                score = score / n
        else:
            total = torch.clamp(_scalar_sum(local_den, group), min=1.0)
            share = local_den / total
            trees = tuple(all_reduce(t * share.to(t.dtype), group)
                          for t in trees)
            score = _scalar_sum(score * local_den, group) / total
        g = len(pbufs)
        return trees[:g], trees[g:2 * g], trees[2 * g:], score

    return compute


def _zero1_program(conf, mesh: Mesh, axis: str, masked: bool,
                   flat: FlatState,
                   tp: Optional[TensorParallel] = None) -> Callable:
    """The ZeRO-1 step: reduce-scatter of the flat gradient, the updater
    on this rank's chunk, and (in `_zero1_write`) the all-gather of the
    params; `tp` as in `_sync_program`, the chunks those of this rank's
    shards."""
    out_conf = conf.conf(conf.n_layers - 1)
    n, group = mesh.shape[axis], mesh.axis_group(axis)
    rank = _rank(mesh, axis)
    spec, chunk = flat.spec, flat.chunk
    norm = _plan_norm(flat, chunk, rank, n, group, tp)

    def compute(bufs, x, y, *rest):
        pbufs, hbufs, vbufs = bufs
        w, consts, key = _split_inputs(rest, masked)
        k, shard_tp = _shard_key(key, rank, n, x.shape[0], tp)
        den = None
        if w is not None:
            den = torch.clamp(_scalar_sum(w.sum(), group), min=1.0)
        loss = _loss_fn(conf, x, y, w, den, n, False, dot=True, tp=shard_tp)
        grads, score, _ = _grads(loss, flat_unravel(spec, pbufs), k)
        gchunks = []
        for g, c in zip(flat_ravel(spec, grads), chunk):
            out = g.new_empty(c)
            reduce_scatter(out, _padded(g, c * n), group)
            gchunks.append(out / n if w is None and n > 1 else out)
        score = _scalar_sum(score, group)
        if w is None and n > 1:
            score = score / n
        pchunks = tuple(b[rank * c:(rank + 1) * c]
                        for b, c in zip(pbufs, chunk))
        adj, upd = adjust_gradient_flat(out_conf, 0, tuple(gchunks),
                                        pchunks, UpdaterState(hbufs, vbufs),
                                        spec, consts=consts, norm_fn=norm)
        new = tuple(p - a.to(p.dtype) for p, a in zip(pchunks, adj))
        return new, upd.adagrad_hist, upd.velocity, score

    return compute


def _zero1_write(group) -> Callable:
    def write(bufs, out):
        pbufs, hbufs, vbufs = bufs
        new, hist, vel, score = out
        for dst, src in zip(hbufs + vbufs, tuple(hist) + tuple(vel)):
            dst.copy_(src)
        # the params come back whole: every rank's chunk gathered
        for dst, src in zip(pbufs, new):
            all_gather(dst, src, group)
        return score

    return write


class DPStep:
    """A data-parallel step: `step(state, x, y, [w,] key) -> (state,
    score)` on this rank's shards of x and y (`shard_batch`), the state's
    buffers written in place and its step advanced; `key` is the batch's
    key (two ints or an int64 [2] tensor), drawn only where the conf
    drops. Through `cache` (a `DPStepCache`) the step is a captured
    program; without one it runs eagerly."""

    def __init__(self, conf, mesh: Mesh, axis: str, variant: Tuple,
                 masked: bool, make: Callable, write: Callable = _write_state,
                 cache: Optional[DPStepCache] = None, grad_accum: int = 1,
                 local_steps: int = 0):
        self.conf, self.mesh, self.axis = conf, mesh, axis
        self.variant, self.masked = variant, masked
        self.make, self.write, self.cache = make, write, cache
        self.grad_accum, self.local_steps = grad_accum, local_steps

    def _consts(self, step: int) -> torch.Tensor:
        out_conf = self.conf.conf(self.conf.n_layers - 1)
        if self.local_steps:
            c = np.stack([iteration_constants(out_conf, step + it)
                          for it in range(self.local_steps)])
        else:
            c = iteration_constants(out_conf, step)
        return torch.from_numpy(c).to(self.mesh.device)

    def inputs(self, state: TrainState, x, y, w, key) -> tuple:
        dev = self.mesh.device
        inputs = [x.to(dev), y.to(dev)]
        if self.masked:
            inputs.append(w.to(dev))
        inputs.append(self._consts(state.step))
        if key is not None and uses_key(self.conf):
            inputs.append(nd_random.key_array(
                [int(v) for v in key] if not isinstance(key, torch.Tensor)
                else key, dev))
        return tuple(inputs)

    def __call__(self, state: TrainState, x, y, *rest, checked=False):
        w = rest[0] if self.masked else None
        key = rest[-1] if len(rest) > int(self.masked) else None
        if self.grad_accum > 1 and (x.shape[0] % self.grad_accum
                                    or y.shape[0] % self.grad_accum):
            raise ValueError(
                f"per-shard batch {x.shape[0]} (labels {y.shape[0]}) not "
                f"divisible by grad_accum={self.grad_accum}")
        if not checked:
            check_input(self.conf, x)
        flat = state.flat
        bufs = (flat.params, flat.hist, flat.vel)
        inputs = self.inputs(state, x, y, w, key)
        if self.cache is not None:
            score = self.cache.step(self.variant, self.conf,
                                    lambda: self.make(flat), bufs, inputs,
                                    self.write)
        else:
            with ids_checked():
                score = self.write(bufs, self.make(flat)(bufs, *inputs))
        return state._replace(step=state.step + (self.local_steps or 1)), \
            score


def make_dp_train_step(conf, mesh: Mesh, axis: str = "dp",
                       masked: bool = False, grad_accum: int = 1,
                       cache: Optional[DPStepCache] = None) -> DPStep:
    """One data-parallel training step: the gradient all-reduced over the
    mesh's ranks, then the updater chain. `masked` adds per-label-row
    weights w, the remainder-batch path (pad rows weigh 0; the global loss
    is psum(sum(w * rows)) / max(psum(sum(w)), 1) + regularization).
    `grad_accum=k` splits each shard's batch into k microbatches and
    applies one update from their averaged gradients: only on the
    unmasked path of a BatchNorm-free network, and the shard's batch must
    divide by k. `cache` (a `DPStepCache`) captures the step."""
    if grad_accum > 1 and (masked or has_batchnorm(conf)):
        raise ValueError("grad_accum requires the unmasked path on a "
                         "batchnorm-free network")
    return DPStep(conf, mesh, axis, ("dp_step", axis, masked, grad_accum),
                  masked, lambda flat: _sync_program(
                      conf, mesh, axis, masked, grad_accum, flat),
                  cache=cache, grad_accum=grad_accum)


def make_masked_dp_train_step(conf, mesh: Mesh, axis: str = "dp",
                              cache: Optional[DPStepCache] = None) -> DPStep:
    return make_dp_train_step(conf, mesh, axis, masked=True, cache=cache)


def make_zero1_train_step(conf, mesh: Mesh, axis: str = "dp",
                          masked: bool = False,
                          cache: Optional[DPStepCache] = None) -> DPStep:
    """The data-parallel step with ZeRO-1 updater-state sharding, on a
    state from `zero1_shard_state`: the flat gradient reduce-scattered,
    this rank's chunk of the updater stepped, the params all-gathered.
    `masked` is the pad-and-mask variant (loss = dot(rows, w) / max(sum w,
    1) + regularization, over the global batch). BatchNorm nets raise, as
    in the JAX package."""
    if has_batchnorm(conf):
        raise ValueError("zero1 step does not support BatchNorm nets "
                         "(per-batch stats need the shard_map path)")
    return DPStep(conf, mesh, axis, ("zero1_step", axis, masked), masked,
                  lambda flat: _zero1_program(conf, mesh, axis, masked,
                                              flat),
                  write=_zero1_write(mesh.axis_group(axis)), cache=cache)


def make_averaging_round(conf, mesh: Mesh, local_steps: int,
                         axis: str = "dp", masked: bool = False,
                         cache: Optional[DPStepCache] = None) -> DPStep:
    """One BSP IterativeReduce round: `local_steps` updater steps on each
    rank's own shard (each on the next split of its folded key), then the
    params and updater state averaged over the ranks. `masked`: local
    losses are weighted means over each rank's real rows, and the average
    weights each rank by its real-row count (a rank of pad rows only
    contributes nothing). The state's step advances by `local_steps`."""
    return DPStep(conf, mesh, axis,
                  ("dp_averaging", axis, masked, local_steps), masked,
                  lambda flat: _averaging_program(conf, mesh, axis, masked,
                                                  local_steps, flat.spec),
                  cache=cache, local_steps=local_steps)


def make_masked_averaging_round(conf, mesh: Mesh, local_steps: int,
                                axis: str = "dp",
                                cache: Optional[DPStepCache] = None
                                ) -> DPStep:
    return make_averaging_round(conf, mesh, local_steps, axis, masked=True,
                                cache=cache)


# -- tensor parallelism: a plan with a model axis ----------------------------

def plan_tp(conf, plan) -> TensorParallel:
    """The model axis of `plan` as the layers see it (`parallel/tensor.py`):
    its group, size, this rank's coordinate, and `conf`'s split leaves."""
    size = plan.model_size
    if not plan.has_model_axis:
        return TensorParallel(None, 1, 0, tp_layout(conf, 1))
    mesh = plan.mesh
    return TensorParallel(mesh.axis_group(plan.model_axis), size,
                          mesh.coord(plan.model_axis), tp_layout(conf, size))


def _leaf_names(params) -> list:
    """(layer, name) of every leaf of a params tree, in `tree_leaves`
    order."""
    return [(i, name) for i, layer in enumerate(params)
            for name in sorted(layer)]


def shard_params(params, tp: TensorParallel):
    """This rank's shards of a whole params tree (tensors or numpy
    arrays): split leaves cut to their pieces (`tensor.shard_leaf`), every
    other leaf as it is."""
    if isinstance(params, dict):
        params = [params[k] for k in sorted(params, key=int)]
    return tuple({name: shard_leaf(a, tp.layout.get((i, name))
                                   if tp.size > 1 else None,
                                   tp.size, tp.rank)
                  for name, a in layer.items()}
                 for i, layer in enumerate(params))


def plan_params_from_numpy(params, conf, plan, device) -> tuple:
    """The JAX package's whole params (numpy arrays, a tuple of dicts or
    a checkpoint's nested dict) as this rank's shards of `plan`, tensors on
    `device`: the start both packages are held to."""
    from deeplearning4j_tpu_torch.parallel.checkpoint import \
        params_from_numpy

    return params_from_numpy(shard_params(params, plan_tp(conf, plan)),
                             device)


def gather_params(params, tp: TensorParallel):
    """The whole params tree from every model rank's shards (a collective
    over the model group: each of its ranks calls it)."""
    if tp.size == 1:
        return params
    out = []
    for i, layer in enumerate(params):
        whole = {}
        for name, t in layer.items():
            split = tp.layout.get((i, name))
            if split is None:
                whole[name] = t
                continue
            t = t.detach().contiguous()
            buf = t.new_empty((tp.size * t.shape[0],) + tuple(t.shape[1:]))
            all_gather(buf, t, tp.group)
            whole[name] = unshard_leaf(buf.view((tp.size,) + t.shape),
                                       split)
        out.append(whole)
    return tuple(out)


def plan_shard_state(state: TrainState, plan, zero1: bool = False, *,
                     conf) -> TrainState:
    """A whole TrainState (`init_train_state`) placed per a model-axis
    plan: params and updater moments cut to this rank's shards of
    `conf`'s layout, and under ZeRO-1 the updater's flat buffers further
    cut into the batch axis's chunks, of which this rank keeps its own."""
    tp = plan_tp(conf, plan)
    upd = state.updater
    return _state_from_trees(
        shard_params(state.params, tp),
        UpdaterState(shard_params(upd.adagrad_hist, tp),
                     shard_params(upd.velocity, tp)),
        state.step, plan.batch_size, plan.mesh.coord(plan.batch_axis),
        zero1=zero1)


def _sharded_norm(spec: FlatSpec, chunk, rank: int, n: int, group,
                  split=(), tp: Optional[TensorParallel] = None):
    """`flat_norm` of a step held in shards: each leaf's squared sum over
    the part of it in this rank's chunk (`chunk`, ZeRO-1; None: the whole
    buffer), summed over the batch group's ranks, a leaf split over the
    model axis (`split`, a flag a leaf) summed over `tp`'s group too, a
    whole leaf counted once; then added up leaf by leaf as `flat_norm`
    adds them."""
    split_idx = [i for i, s in enumerate(split) if s]

    def norm(bufs):
        parts = []
        for g, o, size in spec.leaf_slices:
            if chunk is None:
                parts.append(torch.sum(torch.square(
                    bufs[g][o:o + size].float())))
                continue
            c = chunk[g]
            lo, hi = max(o, rank * c), min(o + size, (rank + 1) * c)
            if hi > lo:
                seg = bufs[g][lo - rank * c:hi - rank * c]
                parts.append(torch.sum(torch.square(seg.float())))
            else:
                parts.append(torch.zeros((), dtype=torch.float32,
                                         device=bufs[g].device))
        sq = torch.stack(parts)
        if chunk is not None and n > 1:
            all_reduce(sq, group)
        vals = list(sq.unbind())
        if split_idx:
            model = all_reduce(torch.stack([vals[i] for i in split_idx]),
                                tp.group)
            for j, i in enumerate(split_idx):
                vals[i] = model[j]
        return torch.sqrt(sum(vals))

    return norm


def make_plan_train_step(conf, plan, masked: bool = False,
                         zero1: bool = False,
                         cache: Optional[DPStepCache] = None) -> DPStep:
    """The training step of a `parallel.plan.ShardPlan` with a model axis,
    on a state from `plan_shard_state`: the attention and FFN blocks split
    over the model axis (`parallel/tensor.py`; the flash kernels run on
    each rank's H/M heads), the batch over the batch axis, the gradient
    all-reduced over the batch group. `masked` is the pad-and-mask
    variant ((state, x, y, w, key), dot-form weighted mean over the global
    batch); `zero1` reduce-scatters the gradient over the batch group,
    steps this rank's chunk of the updater and all-gathers the params
    (ZeRO-1's chunks of this rank's flat buffers). Keyed as the JAX
    package keys it: ("plan_step", plan.sharding_tag(), masked, zero1).
    BatchNorm nets raise, as in the JAX package."""
    if has_batchnorm(conf):
        raise ValueError("plan step does not support BatchNorm nets "
                         "(per-batch stats need the shard_map path)")
    tp = plan_tp(conf, plan)
    mesh, axis = plan.mesh, plan.batch_axis
    variant = ("plan_step", plan.sharding_tag(), masked, zero1)
    if zero1:
        return DPStep(conf, mesh, axis, variant, masked,
                      lambda flat: _zero1_program(conf, mesh, axis, masked,
                                                  flat, tp),
                      write=_zero1_write(mesh.axis_group(axis)), cache=cache)
    return DPStep(conf, mesh, axis, variant, masked,
                  lambda flat: _sync_program(conf, mesh, axis, masked, 1,
                                             flat, tp),
                  cache=cache)


# -- the trainer ------------------------------------------------------------

class DataParallelTrainer:
    """Drives a MultiLayerNetwork over a mesh of ranks (the reference's
    `DeepLearning4jDistributed` and `SparkDl4jMultiLayer`).

    mode="sync"      per-step gradient all-reduce
    mode="averaging" BSP: `local_steps` local steps, then an average
    zero1=True       sync with ZeRO-1 updater-state sharding; checkpoints
                     gather the updater whole, so the elastic resume
                     covers it
    plan=ShardPlan   a `parallel.plan.ShardPlan` with a model axis: the
                     tensor-parallel step (`make_plan_train_step`; sync
                     only, zero1 composes), params and moments held as
                     this rank's shards, checkpoints in the sharded
                     layout; at the end of `fit` the network's params are
                     whole on every rank. A 1-D plan runs the dp path on
                     its mesh.

    Every rank constructs the trainer and calls `fit` on the same batch
    stream; each takes its own shard of every batch."""

    def __init__(self, net: MultiLayerNetwork, mesh: Optional[Mesh] = None,
                 mode: str = "sync", local_steps: int = 5,
                 axis: str = "dp", listeners=(), grad_accum: int = 1,
                 zero1: bool = False, plan=None):
        self.plan = plan
        self.tp = None
        if plan is not None and plan.has_model_axis:
            mesh, axis = plan.mesh, plan.batch_axis
            if mode != "sync":
                raise ValueError("a model-axis plan requires mode='sync'")
            if grad_accum > 1:
                raise ValueError("a model-axis plan does not compose "
                                 "with grad_accum yet")
            if has_batchnorm(net.conf):
                raise ValueError("plan step does not support BatchNorm "
                                 "nets (per-batch stats need the "
                                 "shard_map path)")
            self.tp = plan_tp(net.conf, plan)
        elif mesh is None:
            if plan is None:
                raise ValueError("pass mesh= or plan=")
            mesh, axis = plan.mesh, plan.batch_axis
        if torch.device(net.device) != mesh.device:
            raise ValueError(
                f"the network lies on {net.device}, this rank's mesh on "
                f"{mesh.device}: build the network on mesh.device (under "
                f"torchrun each rank has a card of its own)")
        self.net = net
        self.mesh = mesh
        self.axis = axis
        self.mode = mode
        self.zero1 = bool(zero1)
        self.listeners = list(listeners)
        if net.params is None:
            net.init()
        self.compile_cache = DPStepCache()
        if self.tp is not None:
            self._step = make_plan_train_step(net.conf, plan, zero1=zero1,
                                              cache=self.compile_cache)
        elif zero1:
            if mode != "sync":
                raise ValueError("zero1=True requires mode='sync' (the "
                                 "averaging round replicates its carry)")
            if grad_accum > 1:
                raise ValueError("zero1=True does not compose with "
                                 "grad_accum yet")
            self._step = make_zero1_train_step(net.conf, mesh, axis,
                                               cache=self.compile_cache)
        elif mode == "sync":
            self._step = make_dp_train_step(net.conf, mesh, axis,
                                            grad_accum=grad_accum,
                                            cache=self.compile_cache)
        elif mode == "averaging":
            if grad_accum > 1:
                raise ValueError(
                    "grad_accum is only supported in mode='sync'")
            self._step = make_averaging_round(net.conf, mesh, local_steps,
                                              axis, cache=self.compile_cache)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        self._local_steps = local_steps
        self._grad_accum = grad_accum
        self._masked_step = None  # built on the first remainder batch
        self.state = init_train_state(net)
        if self.tp is not None:
            self.state = plan_shard_state(self.state, plan, zero1,
                                          conf=net.conf)
        elif zero1:
            self.state = zero1_shard_state(self.state, mesh, axis)
        # the JAX package's key: PRNGKey(seed), split once a batch
        self._key = (0, int(net.conf.confs[0].seed or 0) & 0xFFFFFFFF)
        # crash safety: the SIGTERM flag checked between batches, resume
        # provenance, write-cost accounting
        self._stop_training = threading.Event()
        self.resumed_from_step: Optional[int] = None
        self.checkpoint_write_seconds = 0.0
        self.checkpoints_written = 0
        # NCCL makes a group's communicator at its first collective, which
        # a graph capture cannot hold: one eager collective on each group
        all_reduce(torch.zeros(1, device=mesh.device), mesh.group)
        for a in mesh.axis_names:
            if mesh.axis_group(a) is not mesh.group:
                all_reduce(torch.zeros(1, device=mesh.device),
                            mesh.axis_group(a))

    @property
    def n_ranks(self) -> int:
        return self.mesh.shape[self.axis]

    def _next_key(self):
        self._key, sub = nd_random.split_host(self._key)
        return sub

    # -- checkpoint / elastic resume ----------------------------------------
    def mesh_meta(self) -> dict:
        """The topology recorded in every checkpoint this trainer writes:
        enough for a loader to detect an N->M or zero1 change on resume."""
        return {"axis_names": list(self.mesh.axis_names),
                "shape": {a: int(self.mesh.shape[a])
                          for a in self.mesh.axis_names},
                "zero1": self.zero1}

    def _check_mesh_meta(self, meta: dict) -> None:
        """Log every difference between the checkpoint's topology and this
        mesh: the resume handles them (leaves are saved whole), but
        silently is how divergence hides."""
        ck = meta.get("mesh") or {}
        if not ck:
            return
        ck_axes = list(ck.get("axis_names") or [])
        cur_axes = list(self.mesh.axis_names)
        if ck_axes != cur_axes:
            log.warning("checkpoint mesh axes %s != current %s; leaves "
                        "re-place on the current mesh", ck_axes, cur_axes)
        ck_shape = {k: int(v) for k, v in (ck.get("shape") or {}).items()}
        cur_shape = {a: int(self.mesh.shape[a]) for a in cur_axes}
        if ck_shape != cur_shape:
            log.info("elastic resume: checkpoint written on mesh %s, "
                     "resuming on %s", ck_shape, cur_shape)
        if bool(ck.get("zero1", False)) != self.zero1:
            log.info("checkpoint zero1=%s, trainer zero1=%s: updater "
                     "state re-places per the current mode",
                     bool(ck.get("zero1", False)), self.zero1)

    def _place_state(self, state: TrainState) -> TrainState:
        """Copy a restored state (whole trees, from any topology) into
        this trainer's buffers in place, so that its captured steps stay
        valid: params whole, the updater whole or, under ZeRO-1, this
        rank's chunk of it."""
        flat = self.state.flat
        n, rank = self.n_ranks, _rank(self.mesh, self.axis)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self.state.params),
                                tree_leaves(state.params)):
                dst.copy_(torch.as_tensor(src))
            if flat.chunk is None:
                for dst, src in zip(tree_leaves(self.state.updater),
                                    tree_leaves(state.updater)):
                    dst.copy_(torch.as_tensor(src))
            else:
                for dsts, tree in ((flat.hist, state.updater.adagrad_hist),
                                   (flat.vel, state.updater.velocity)):
                    src = flat_ravel(flat.spec, tree_map(
                        lambda a: torch.as_tensor(a).to(
                            flat.params[0].device), tree))
                    for dst, b, c in zip(dsts, src, flat.chunk):
                        dst.copy_(_padded(b, c * n)[rank * c:(rank + 1) * c])
        self.state = self.state._replace(step=int(state.step))
        return self.state

    def _copy_to_net(self) -> None:
        """The trainer's params into the network's own tensors, in place:
        the network's captured graphs read them by address. Under a model
        axis they are first gathered whole (a collective over the model
        group)."""
        params = self.state.params
        if self.tp is not None:
            params = gather_params(params, self.tp)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self.net.params),
                                tree_leaves(params)):
                dst.copy_(src)
        self.net.params_written()

    def _apply_restored(self, params, updater, meta: dict) -> None:
        self._check_mesh_meta(meta)
        step = int(meta.get("step", 0))
        self._place_state(TrainState(params=params, updater=updater,
                                     step=step))
        self._copy_to_net()
        rng = (meta.get("metadata") or {}).get("rng_key")
        if rng is not None:
            # without the key a resumed run draws another dropout stream
            # and parts from the uninterrupted one
            self._key = tuple(int(v) & 0xFFFFFFFF for v in rng)
        self.resumed_from_step = step

    def _like_updater(self) -> UpdaterState:
        return UpdaterState(adagrad_hist=self.state.params,
                            velocity=self.state.params)

    def restore(self, directory: str) -> int:
        """Resume from a checkpoint: params, updater state, step and the
        host key land in this trainer, whatever mesh wrote it. Returns the
        restored step."""
        from deeplearning4j_tpu_torch.parallel import checkpoint

        params, updater, meta = checkpoint.load(
            directory, like_params=self.state.params,
            like_updater=self._like_updater(), tp=self.tp)
        self._apply_restored(params, updater, meta)
        return int(meta["step"])

    def checkpoint_state(self):
        """(params, updater, step) as a checkpoint holds them: the updater
        gathered whole over the batch axis under ZeRO-1 (a collective);
        under a model axis both are this rank's shards."""
        return (self.state.params,
                gather_updater(self.state, self.mesh, self.axis),
                int(self.state.step))

    def gathered_state(self):
        """(params, updater, step), every leaf whole: `checkpoint_state`
        with the model axis's shards gathered too (a collective over every
        rank). For holding a run to a whole-params reference; a checkpoint
        never takes this."""
        params, updater, step = self.checkpoint_state()
        if self.tp is None:
            return params, updater, step
        return (gather_params(params, self.tp),
                UpdaterState(gather_params(updater.adagrad_hist, self.tp),
                             gather_params(updater.velocity, self.tp)),
                step)

    def _save_checkpoint(self, directory: str, batches_done: int) -> None:
        """A synchronous atomic checkpoint of the whole cross-batch state:
        params, updater moments (ZeRO-1 chunks gathered), step, the host
        key and the data cursor. Rank 0 writes; the others wait for it."""
        from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt

        t0 = time.perf_counter()
        params, updater, step = self.checkpoint_state()
        kw = dict(conf=self.net.conf, step=step,
                  data_cursor={"batches_done": int(batches_done)},
                  metadata={"rng_key": [int(v) for v in self._key]},
                  mesh=self.mesh_meta())
        if self.tp is None:
            ckpt.save(directory, params, updater, **kw)
        elif self.mesh.coord(self.axis) == 0:
            # the sharded layout: the model ranks of batch coordinate 0
            # send their pieces to rank 0, which writes; no rank assembles
            # a split leaf whole
            ckpt.save_sharded(directory, params, updater, tp=self.tp, **kw)
        if math.prod(self.mesh.shape.values()) > 1:
            import torch.distributed as dist

            dist.barrier(group=self.mesh.group)
        self.checkpoint_write_seconds += time.perf_counter() - t0
        self.checkpoints_written += 1

    def request_stop_training(self) -> None:
        """Ask a running `fit(checkpoint_dir=...)` to checkpoint and raise
        `TrainingInterrupted` after the current batch (what the installed
        SIGTERM handler calls)."""
        self._stop_training.set()

    def _stop_agreed(self) -> bool:
        """Whether any rank was asked to stop. The signal reaches the ranks
        between different batches, and a rank that checkpoints (collectives
        of its own) while another steps on would hang both: at more than
        one rank the flag is all-reduced (MAX) after every batch, and every
        rank stops at the same cursor."""
        stop = self._stop_training.is_set()
        if math.prod(self.mesh.shape.values()) == 1:
            return stop
        import torch.distributed as dist

        flag = torch.tensor([float(stop)], device=self.mesh.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return bool(flag.item())

    def _masked(self) -> DPStep:
        if self._masked_step is None:
            if self._grad_accum > 1:
                # the masked path has no accumulation
                log.warning("a remainder batch runs the masked step "
                            "WITHOUT grad_accum=%d (one forward and "
                            "backward)", self._grad_accum)
            if self.tp is not None:
                self._masked_step = make_plan_train_step(
                    self.net.conf, self.plan, masked=True, zero1=self.zero1,
                    cache=self.compile_cache)
            elif self.zero1:
                self._masked_step = make_zero1_train_step(
                    self.net.conf, self.mesh, self.axis, masked=True,
                    cache=self.compile_cache)
            elif self.mode == "sync":
                self._masked_step = make_masked_dp_train_step(
                    self.net.conf, self.mesh, self.axis,
                    cache=self.compile_cache)
            else:
                self._masked_step = make_masked_averaging_round(
                    self.net.conf, self.mesh, self._local_steps, self.axis,
                    cache=self.compile_cache)
        return self._masked_step

    def _step_padded(self, x: torch.Tensor, y: torch.Tensor):
        """Zero-pad a remainder batch to a multiple of the ranks and run
        the masked step (pad rows weigh 0). Label rows may be a multiple of
        feature rows (B*T for sequence models): the mask follows them."""
        n = self.n_ranks
        b = x.shape[0]
        pad = n - b % n
        ratio = max(1, y.shape[0] // max(1, b))
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        y = torch.cat([y, y.new_zeros((pad * ratio,) + tuple(y.shape[1:]))])
        w = torch.cat([torch.ones(b * ratio), torch.zeros(pad * ratio)])
        x, y, w = shard_batch(self.mesh, (x, y, w), self.axis)
        return self._masked()(self.state, x, y, w, self._next_key(),
                              checked=True)

    def fit(self, data: Iterable, epochs: int = 1, *,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every_n_batches: int = 0,
            auto_resume: bool = True) -> float:
        """Train over `data`, which yields (features, labels) or DataSets;
        a batch the ranks do not divide is padded and masked (in every
        mode). Returns the last score.

        With `checkpoint_dir` the run is crash-safe and elastic: params,
        updater moments, step, the host key and the batch cursor are
        checkpointed atomically every `checkpoint_every_n_batches` batches
        and at the end; a SIGTERM to any rank checkpoints (every rank at
        the same batch), then raises `TrainingInterrupted`; and a rerun
        with the same directory and batch stream resumes at the saved
        cursor on any number of ranks (bitwise on the same topology). The
        cursor counts across epochs."""
        start_batch = 0
        if checkpoint_dir is not None and auto_resume:
            start_batch = self._try_resume(checkpoint_dir)
        if checkpoint_dir is None:
            return self._fit_loop(data, epochs, None, 0, 0)
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
        try:
            return self._fit_loop(data, epochs, checkpoint_dir,
                                  int(checkpoint_every_n_batches),
                                  start_batch)
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev_handler)

    def _try_resume(self, directory: str) -> int:
        """Restore the newest valid checkpoint under `directory` (or its
        .bak); returns the batch cursor to skip to (0: nothing resumed)."""
        from deeplearning4j_tpu_torch.parallel import checkpoint

        restored = checkpoint.load_resilient(
            directory, like_params=self.state.params,
            like_updater=self._like_updater(), tp=self.tp)
        if restored is None:
            return 0
        params, updater, meta = restored
        self._apply_restored(params, updater, meta)
        cursor = int((meta.get("data_cursor") or {}).get("batches_done", 0))
        log.info("mesh fit: auto-resumed %s at batch %d (step %d, mesh %s)",
                 directory, cursor, self.resumed_from_step,
                 (meta.get("mesh") or {}).get("shape"))
        return cursor

    def _fit_loop(self, data, epochs: int, checkpoint_dir: Optional[str],
                  every_n: int, start_batch: int) -> float:
        score = None
        n = self.n_ranks
        n_done = 0
        for _ in range(epochs):
            if hasattr(data, "reset"):
                data.reset()
            for batch in data:
                n_done += 1
                if n_done <= start_batch:
                    # the resumed prefix of the stream: skipped, and no key
                    # is taken (the restored key accounts for them)
                    continue
                faults.fire("trainer.step", batch=n_done)
                x, y = ((batch.features, batch.labels)
                        if hasattr(batch, "features") else batch)
                x, y = batch_tensor(x), batch_tensor(y)
                check_input(self.net.conf, x)
                if x.shape[0] % n:
                    # pad-and-mask: every real example still counts once
                    self.state, s = self._step_padded(x, y)
                else:
                    xs, ys = shard_batch(self.mesh, (x, y), self.axis)
                    self.state, s = self._step(self.state, xs, ys,
                                               self._next_key(),
                                               checked=True)
                score = s
                for li in self.listeners:
                    li.iteration_done(self, int(self.state.step), float(s))
                if checkpoint_dir is not None:
                    if self._stop_agreed():
                        self._save_checkpoint(checkpoint_dir, n_done)
                        raise TrainingInterrupted(
                            f"stop requested: checkpointed {checkpoint_dir}"
                            f" at batch {n_done}")
                    if every_n > 0 and n_done % every_n == 0:
                        self._save_checkpoint(checkpoint_dir, n_done)
        if checkpoint_dir is not None and n_done > start_batch:
            self._save_checkpoint(checkpoint_dir, n_done)
        # the network takes the trained params, in place
        self._copy_to_net()
        return float(score) if score is not None else float("nan")

