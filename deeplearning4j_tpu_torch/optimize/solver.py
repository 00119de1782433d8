"""The solver: plain stepped gradient descent through the updater chain.

Counterpart of `deeplearning4j_tpu/optimize/solver.py` for the
`ITERATION_GRADIENT_DESCENT` algorithm, which the zoo's nets train with.
The JAX package runs the iterations as one `lax.scan` and masks every
update once a termination condition trips. The port has two forms that
give the same params and per-iteration scores: `_sgd`, a Python loop that
reads the score and the two norms back once per iteration and stops
updating once it is done (the eager path), and `sgd_device`, which keeps
that state on the device and masks as the scan does, so that a CUDA graph
can capture the whole run (`optimize/step_cache.py`).

Keys: an objective takes `(params, key)`. With a key (an int64 [2] tensor)
the solver splits it once per iteration, `k, sub = split(k)`, and hands
`sub` to the objective, as JAX's scan does; dropout draws its masks from
it. Without one (no layer drops anything) nothing is split.

Aux: an objective with `grad_score_aux` also returns an aux tree from its
forward (the BatchNorm moments); the solver keeps the aux of the last
iteration that updated the params, masked by `done` as JAX masks it, and
returns it beside the params (`optimize_with_aux`, `sgd_device`). The
line-searched, conjugate-gradient, LBFGS and Hessian-free solvers are not
ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nn.conf import OptimizationAlgorithm
from deeplearning4j_tpu_torch.optimize.tree import (tree_leaves, tree_map,
                                                    tree_unflatten)
from deeplearning4j_tpu_torch.optimize.updater import (adjust_gradient,
                                                       adjust_gradient_flat,
                                                       flat_norm, flat_ravel,
                                                       flat_unravel,
                                                       init_updater,
                                                       make_flat_spec,
                                                       tree_norm)

EPS_TERMINATION = 1e-6   # |score - old_score| tolerance (EpsTermination)
NORM2_TERMINATION = 1e-8  # gradient-norm tolerance (Norm2Termination)
# consecutive sub-eps iterations before terminating: one exactly-equal f32
# score pair is a rounding coin-flip, not convergence
STALL_PATIENCE = 2


class Objective(NamedTuple):
    """What a solver optimizes.

    grad_and_score(params, key=None) -> (grads tree, scalar score tensor)
    score(params, key=None) -> scalar score tensor
    grad_score_aux(params, key=None) -> (grads, score, aux tree), or None
    """

    grad_and_score: Callable
    score: Callable
    grad_score_aux: Optional[Callable] = None


def _grads(loss_aux: Callable, params, key):
    """(grads, score, aux) of `loss_aux(params, key) -> (scalar, aux)` by
    autograd with respect to every leaf; a leaf the loss does not reach
    gets zeros."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        s, aux = loss_aux(tree_unflatten(params, leaves), key)
    grads = torch.autograd.grad(s, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    return (tree_unflatten(params, grads), s.detach(),
            tree_map(lambda a: a.detach(), aux))


def from_loss(loss_fn: Callable, with_key: bool = False) -> Objective:
    """An Objective from a loss `(params) -> scalar tensor`, or `(params,
    key) -> scalar tensor` with `with_key`: gradients by autograd."""
    call = loss_fn if with_key else (lambda p, k: loss_fn(p))

    def grad_and_score(params, key=None):
        g, s, _ = _grads(lambda p, k: (call(p, k), ()), params, key)
        return g, s

    def score(params, key=None):
        with torch.no_grad():
            return call(params, key)

    return Objective(grad_and_score=grad_and_score, score=score)


def from_loss_with_aux(loss_fn: Callable) -> Objective:
    """An Objective from `(params, key) -> (scalar, aux tree)` whose aux
    (detached) rides `grad_score_aux`, JAX's `value_and_grad(...,
    has_aux=True)` objective."""

    def grad_score_aux(params, key=None):
        return _grads(loss_fn, params, key)

    def score(params, key=None):
        with torch.no_grad():
            return loss_fn(params, key)[0]

    return Objective(
        grad_and_score=lambda p, key=None: grad_score_aux(p, key)[:2],
        score=score, grad_score_aux=grad_score_aux)


def _grad_score_aux(objective: Objective, params, key):
    """(grads, score, aux) whichever channel the objective provides."""
    if objective.grad_score_aux is not None:
        return objective.grad_score_aux(params, key)
    g, s = objective.grad_and_score(params, key)
    return g, s, ()


def _aux_zeros(objective: Objective, params0, key):
    """The aux of a run with no iteration: zeros shaped like the
    objective's aux (JAX's initial scan carry)."""
    if objective.grad_score_aux is None:
        return ()
    return tree_map(torch.zeros_like,
                    objective.grad_score_aux(params0, key)[2])


def _split_key(k):
    """(next carry key, this iteration's key), JAX's `k, sub = split(k)`;
    (None, None) without a key."""
    if k is None:
        return None, None
    ks = nd_random.split(k)
    return ks[0], ks[1]


def _termination_settings(conf):
    """(conditions, eps, norm2 floor) from conf."""
    return (tuple(getattr(conf, "termination_conditions", ("eps", "norm2"))
                  or ()),
            getattr(conf, "termination_eps", EPS_TERMINATION),
            getattr(conf, "termination_norm2", NORM2_TERMINATION))


def make_termination(conf):
    """The termination predicate from conf: any of "eps" (a plateau,
    |score - old_score| < termination_eps), "norm2" (gradient norm below
    termination_norm2) and "zero_direction" (step norm below 1e-12); an
    empty tuple never terminates early."""
    conds, eps, n2 = _termination_settings(conf)

    def terminated(score, old_score, gnorm, dnorm=None):
        """(stall, hard): callers terminate after STALL_PATIENCE stalls in a
        row, or at once on a hard condition."""
        stall = "eps" in conds and abs(score - old_score) < eps
        hard = ("norm2" in conds and gnorm < n2) or (
            "zero_direction" in conds and dnorm is not None
            and dnorm < 1e-12)
        return bool(stall), bool(hard)

    return terminated


def apply_step(conf, x, d, alpha):
    """The configured step function: default x + alpha*d; gradient x + d;
    the negative variants flip the sign."""
    sf = (getattr(conf, "step_function", "default") or "default").lower()
    if sf == "gradient":
        return x + d
    if sf == "negative_gradient":
        return x - d
    if sf == "negative_default":
        return x - alpha * d
    return x + alpha * d


def _carry(conf, params0):
    """What the solver loop carries and how it reads it: (params carried,
    to_tree, ravel_grads, norm, adjust). With `conf.fused_updater` params
    and updater state are flat buffers (one per dtype); the gradient is
    still taken on the tree of views into them."""
    if getattr(conf, "fused_updater", False):
        spec = make_flat_spec(params0)
        return (flat_ravel(spec, params0),
                lambda p: flat_unravel(spec, p),
                lambda g: flat_ravel(spec, g),
                lambda t: flat_norm(spec, t),
                lambda it, g, p, u: adjust_gradient_flat(conf, it, g, p, u,
                                                         spec))
    return (params0, lambda p: p, lambda g: g, tree_norm,
            lambda it, g, p, u: adjust_gradient(conf, it, g, p, u))


def _step(conf, objective, it, params, upd, to_tree, ravel_grads, adjust,
          key):
    """One updater-chain iteration: (new params, new updater state, grads,
    step, score, aux). Direction -step, alpha fixed at 1; the configured
    step function applies."""
    grads, score, aux = _grad_score_aux(objective, to_tree(params), key)
    grads = ravel_grads(grads)
    adj, upd = adjust(it, grads, params, upd)
    params = tree_map(lambda p, a: apply_step(conf, p, -a.to(p.dtype), 1.0),
                      params, adj)
    return params, upd, grads, adj, score, aux


def _sgd(objective: Objective, params0, conf, key=None):
    """ITERATION_GRADIENT_DESCENT: updater-chain steps, no line search.

    The updater state starts at zero on every call. Once a termination
    condition trips, params stop changing and the remaining iterations
    report the score there (with each iteration's own key, as JAX's scan
    scores them). Each iteration reads its score and the two norms back to
    the host, which decides termination: the eager form, for
    `use_step_cache=False`; `sgd_device` is the form a CUDA graph captures.
    Returns (params, scores, aux)."""
    params, to_tree, ravel_grads, norm, adjust = _carry(conf, params0)
    upd = init_updater(params)
    terminated = make_termination(conf)
    done, old_score, stall_n, frozen = False, math.inf, 0, None
    scores, aux, k = [], None, key
    for it in range(conf.num_iterations):
        k, sub = _split_key(k)
        if done:
            if frozen is None or sub is not None:
                frozen = float(objective.score(to_tree(params), sub))
            scores.append(frozen)
            continue
        params, upd, grads, adj, score, aux = _step(
            conf, objective, it, params, upd, to_tree, ravel_grads, adjust,
            sub)
        # the one read-back of the iteration
        s, gn, dn = torch.stack([score.float(), norm(grads),
                                 norm(adj)]).tolist()
        scores.append(s)
        stall, hard = terminated(s, old_score, gn, dn)
        stall_n = stall_n + 1 if stall else 0
        done = hard or stall_n >= STALL_PATIENCE
        old_score = s
    if aux is None:
        aux = _aux_zeros(objective, params0, key)
    return to_tree(params), np.asarray(scores, np.float32), aux


def sgd_device(objective: Objective, params0, conf, key=None):
    """The graph-safe form of `_sgd`: the same iterations with nothing read
    back to the host, so that one CUDA graph can hold the whole solver run.

    The `num_iterations` iterations are unrolled. The termination state
    (done, the stall count, the previous score) is carried on the device
    and every update after the first is masked with `torch.where(done,
    old, new)`, as the JAX package's `lax.scan` carries and masks it
    (deeplearning4j_tpu/optimize/solver.py:276-303); termination is
    decided in f32 as there. A masked iteration's score is the score of
    the frozen params, as in both other forms. The aux is masked alike, so
    it is the last live iteration's. Returns (params, scores, aux), the
    scores a [num_iterations] float32 tensor on the params' device."""
    params, to_tree, ravel_grads, norm, adjust = _carry(conf, params0)
    upd = init_updater(params)
    conds, eps, n2 = _termination_settings(conf)
    done = old_score = stall_n = None  # None: nothing has terminated yet
    scores, aux, k = [], None, key
    n_iter = conf.num_iterations
    for it in range(n_iter):
        k, sub = _split_key(k)
        new, upd_new, grads, adj, score, aux_new = _step(
            conf, objective, it, params, upd, to_tree, ravel_grads, adjust,
            sub)
        score = score.float()
        scores.append(score)
        if done is None:
            params, upd, aux = new, upd_new, aux_new
        else:
            def keep(o, n):
                return torch.where(done, o, n)

            params = tree_map(keep, params, new)
            upd = tree_map(keep, upd, upd_new)
            aux = tree_map(keep, aux, aux_new)
        if it + 1 == n_iter:
            break  # the last iteration's termination decides nothing
        hard = torch.zeros((), dtype=torch.bool, device=score.device)
        if "norm2" in conds:
            hard = hard | (norm(grads) < n2)
        if "zero_direction" in conds:
            hard = hard | (norm(adj) < 1e-12)
        stall = (torch.abs(score - old_score) < eps
                 if "eps" in conds and old_score is not None
                 else torch.zeros_like(hard))
        count = torch.where(stall, (0 if stall_n is None else stall_n) + 1,
                            0)
        stall_n = count if done is None else torch.where(done, stall_n,
                                                         count)
        now = hard | (stall_n >= STALL_PATIENCE)
        done = now if done is None else done | now
        old_score = score
    if aux is None:
        aux = _aux_zeros(objective, params0, key)
    return to_tree(params), (torch.stack(scores) if scores
                             else torch.zeros(0)), aux


def optimize_with_aux(objective: Objective, params0, conf, key=None):
    """Run the configured solver: (params, per-iteration scores, aux), aux
    the objective's aux of the last live iteration (the BatchNorm moments),
    () for an objective without one."""
    check_algorithm(conf)
    return _sgd(objective, params0, conf, key)


def check_algorithm(conf) -> None:
    """Raise NotImplementedError for a solver the port does not have."""
    algo = OptimizationAlgorithm(str(conf.optimization_algo))
    if algo != OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT:
        raise NotImplementedError(
            f"optimization algorithm '{algo}' is not ported to "
            f"deeplearning4j_tpu_torch yet; see ROADMAP.md queue A item 9")


def optimize(objective: Objective, params0, conf, key=None):
    """Run the configured solver; returns (params, per-iteration scores)."""
    params, scores, _ = optimize_with_aux(objective, params0, conf, key)
    return params, scores
