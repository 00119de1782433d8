"""Gradient adjustment (the updater chain).

Counterpart of `deeplearning4j_tpu/optimize/updater.py`: a pure
`(conf, iteration, grads, params, state) -> (step, state)` transform over
parameter trees. `conf.updater` selects the algorithm: "" keeps the
reference chain (the AdaGrad flag, with its periodic reset, then scheduled
momentum), "sgd" and "adagrad" force that flag, and "nesterov", "adam" and
"rmsprop" are their own. L2 decay, a global-norm clip and the unit-norm
constraint wrap every algorithm. The returned step has the learning rate
folded in and is subtracted from the params.

`conf.fused_updater` runs the same chain over a few contiguous buffers, one
per dtype (`make_flat_spec`, `flat_ravel`, `flat_unravel`), so each updater
op is one full-width kernel instead of one per leaf. Every op is
elementwise except the two global norms, which `flat_norm` reduces per
original leaf. The JAX package's `optimization_barrier`s pin XLA's fusion
choices; eager PyTorch makes none, so they have no counterpart.
`adjust_gradient_auto` takes trees and honours the flag, as in the JAX
package.

The iteration enters the chain through host constants: Adam's bias
corrections, the scheduled momentum and AdaGrad's reset flag
(`iteration_constants`, float32 arithmetic on the host). A one-call solver
run bakes them in as Python numbers. An updater that persists across
calls (the data-parallel trainer's) passes them as a float32 [4] tensor,
`consts`, which a captured step takes as an input that the host fills
before each replay; the eager and captured steps then read the same
values. Computing `pow` on the device instead would give a captured graph
the iteration alone, but `torch.pow` on the card need not round as
numpy's float32 `**` does, and the constants would part from the solver
run's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.tree import (tree_leaves, tree_map,
                                                    tree_unflatten)


class UpdaterState(NamedTuple):
    adagrad_hist: object   # tree like params (second moment for adam)
    velocity: object       # tree like params (first moment for adam)


def init_updater(params) -> UpdaterState:
    return UpdaterState(adagrad_hist=tree_map(torch.zeros_like, params),
                        velocity=tree_map(torch.zeros_like, params))


def _momentum_at(conf, iteration: int) -> float:
    """Scheduled momentum: the `momentum_after` entry with the largest
    iteration reached, else `conf.momentum`; as an f32 value."""
    m = conf.momentum
    for it, mom in conf.momentum_after:
        if iteration >= it:
            m = mom
    return float(np.float32(m))


#: the fields of `iteration_constants`, in order
ITERATION_CONSTANTS = ("c1", "c2", "momentum", "reset")


def iteration_constants(conf, iteration: int) -> np.ndarray:
    """The host constants of one iteration as float32 [4]: Adam's bias
    corrections c1 = 1 - b1^t and c2 = 1 - b2^t (t = iteration + 1), the
    scheduled momentum, and 1.0 where AdaGrad's history resets at this
    iteration (else 0.0). The values `adjust_gradient` computes for an int
    iteration."""
    t = np.float32(iteration + 1)
    c1 = 1 - np.float32(conf.adam_beta1) ** t
    c2 = 1 - np.float32(conf.adam_beta2) ** t
    reset = (conf.adagrad_reset_iterations > 0
             and iteration % conf.adagrad_reset_iterations == 0)
    return np.array([c1, c2, _momentum_at(conf, iteration), float(reset)],
                    np.float32)


# -- flat-buffer (fused) layout ---------------------------------------------

class FlatSpec(NamedTuple):
    like: object         # the param tree's structure (leaves None)
    shapes: tuple        # per leaf, its shape
    leaf_slices: tuple   # per leaf: (group index, offset, size)
    group_dtypes: tuple  # per dtype group
    group_sizes: tuple


def make_flat_spec(params) -> FlatSpec:
    """Group param leaves by dtype, in first-seen order, into contiguous
    1-D buffer layouts."""
    group_of, offsets, slices = {}, [], []
    leaves = tree_leaves(params)
    for leaf in leaves:
        if leaf.dtype not in group_of:
            group_of[leaf.dtype] = len(group_of)
            offsets.append(0)
        g = group_of[leaf.dtype]
        slices.append((g, offsets[g], leaf.numel()))
        offsets[g] += leaf.numel()
    return FlatSpec(like=tree_map(lambda _: None, params),
                    shapes=tuple(tuple(leaf.shape) for leaf in leaves),
                    leaf_slices=tuple(slices),
                    group_dtypes=tuple(group_of),
                    group_sizes=tuple(offsets))


def flat_ravel(spec: FlatSpec, tree) -> tuple:
    """Tree -> tuple of contiguous 1-D buffers, one per dtype group."""
    parts = [[] for _ in spec.group_sizes]
    for leaf, (g, _, _) in zip(tree_leaves(tree), spec.leaf_slices):
        parts[g].append(leaf.reshape(-1))
    return tuple(torch.cat(p) for p in parts)


def flat_unravel(spec: FlatSpec, bufs):
    """Inverse of `flat_ravel`: the leaves are views into the buffers."""
    leaves = [bufs[g][o:o + n].view(shape)
              for (g, o, n), shape in zip(spec.leaf_slices, spec.shapes)]
    return tree_unflatten(spec.like, leaves)


def flat_norm(spec: FlatSpec, bufs) -> torch.Tensor:
    """sqrt of the global squared f32 norm, reduced per original leaf as
    `tree_norm` reduces it."""
    return torch.sqrt(sum(torch.sum(torch.square(bufs[g][o:o + n].float()))
                          for g, o, n in spec.leaf_slices))


def tree_norm(t) -> torch.Tensor:
    """sqrt of the summed per-leaf squared f32 norms."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(t)))


def adjust_gradient(conf, iteration: int, grads, params,
                    state: UpdaterState, _norm_fn=tree_norm, consts=None):
    """Apply the updater chain; returns (step, new_state). The step is
    subtracted from params. Adam keeps its first moment in `velocity` and
    its second in `adagrad_hist`. `consts`, a float32 [4] tensor of
    `iteration_constants`, replaces what `iteration` gives."""
    eps = 1e-8
    lr = conf.lr
    which = (getattr(conf, "updater", "") or "").lower()

    # L2 weight decay on the raw gradient (before adaptive scaling)
    if conf.use_regularization and conf.l2:
        grads = tree_map(lambda g, p: g + conf.l2 * p.to(g.dtype), grads,
                         params)

    hist = state.adagrad_hist
    vel = state.velocity
    if which == "adam":
        b1, b2 = conf.adam_beta1, conf.adam_beta2
        if consts is None:
            # the bias corrections in f32, as the JAX package computes them
            c1, c2 = (float(c) for c in
                      iteration_constants(conf, iteration)[:2])
        else:
            c1, c2 = consts[0], consts[1]
        vel = tree_map(lambda m, g: b1 * m + (1 - b1) * g, vel, grads)
        hist = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, hist, grads)
        step = tree_map(lambda m, v: lr * (m / c1)
                        / (torch.sqrt(v / c2) + conf.adam_eps), vel, hist)
    elif which == "rmsprop":
        rho = conf.rmsprop_decay
        hist = tree_map(lambda h, g: rho * h + (1 - rho) * g * g, hist,
                        grads)
        step = tree_map(lambda g, h: lr * g / (torch.sqrt(h) + eps), grads,
                        hist)
    elif which == "nesterov":
        mom = (_momentum_at(conf, iteration) if consts is None
               else consts[2])
        vel = tree_map(lambda v, g: mom * v + g, vel, grads)
        # look-ahead step: lr * (g + mu * v_new)
        step = tree_map(lambda g, v: lr * (g + mom * v), grads, vel)
    elif which in ("", "sgd", "adagrad"):
        # the reference chain; "sgd"/"adagrad" force the flag either way
        use_adagrad = (conf.use_adagrad if which == ""
                       else which == "adagrad")
        if use_adagrad:
            if consts is not None and conf.adagrad_reset_iterations > 0:
                hist = tree_map(lambda h, g: torch.where(
                    consts[3] > 0, g * g, h + g * g), hist, grads)
            else:
                resetting = (conf.adagrad_reset_iterations > 0 and iteration
                             % conf.adagrad_reset_iterations == 0)
                hist = tree_map((lambda h, g: g * g) if resetting
                                else (lambda h, g: h + g * g), hist, grads)
            scaled = tree_map(lambda g, h: lr * g / (torch.sqrt(h) + eps),
                              grads, hist)
        else:
            scaled = tree_map(lambda g: lr * g, grads)
        mom = (_momentum_at(conf, iteration) if consts is None
               else consts[2])
        vel = tree_map(lambda v, s: mom * v + s, vel, scaled)
        step = vel
    else:
        raise ValueError(
            f"unknown updater {which!r}: expected one of "
            "'' | sgd | adagrad | nesterov | adam | rmsprop")

    if conf.gradient_clip_norm > 0.0:
        gn = _norm_fn(step)
        scale = torch.clamp(conf.gradient_clip_norm / (gn + eps), max=1.0)
        step = tree_map(lambda x: x * scale.to(x.dtype), step)

    if conf.constrain_gradient_to_unit_norm:
        gn = _norm_fn(step)
        step = tree_map(lambda x: x / (gn + eps).to(x.dtype), step)

    return step, UpdaterState(adagrad_hist=hist, velocity=vel)


def adjust_gradient_flat(conf, iteration: int, grad_bufs, param_bufs,
                         state: UpdaterState, spec: FlatSpec, consts=None,
                         norm_fn=None):
    """The updater chain over `flat_ravel`ed buffers (and state of the same
    layout); the norms reduce per original leaf (`norm_fn` replaces
    `flat_norm`, as ZeRO-1's chunked norm does)."""
    return adjust_gradient(conf, iteration, grad_bufs, param_bufs, state,
                           _norm_fn=norm_fn or (lambda t: flat_norm(spec,
                                                                    t)),
                           consts=consts)


def adjust_gradient_auto(conf, iteration: int, grads, params,
                         state: UpdaterState, consts=None):
    """`adjust_gradient` that honours `conf.fused_updater` on trees: with
    the flag, grads, params and state are raveled at the boundary, the
    chain runs over the flat buffers, and the step and the new state come
    back as trees (views into the buffers). Per element both layouts run
    the same ops, and the norms reduce per original leaf in both, so they
    agree bit for bit."""
    if not getattr(conf, "fused_updater", False):
        return adjust_gradient(conf, iteration, grads, params, state,
                               consts=consts)
    spec = make_flat_spec(params)
    fstate = UpdaterState(adagrad_hist=flat_ravel(spec, state.adagrad_hist),
                          velocity=flat_ravel(spec, state.velocity))
    adj, new = adjust_gradient_flat(conf, iteration, flat_ravel(spec, grads),
                                    flat_ravel(spec, params), fstate, spec,
                                    consts=consts)
    return (flat_unravel(spec, adj),
            UpdaterState(adagrad_hist=flat_unravel(spec, new.adagrad_hist),
                         velocity=flat_unravel(spec, new.velocity)))
