"""The solver: plain stepped gradient descent through the updater chain.

Counterpart of `deeplearning4j_tpu/optimize/solver.py` for the
`ITERATION_GRADIENT_DESCENT` algorithm, which the zoo's nets train with.
The JAX package runs the iterations as one `lax.scan` and masks every
update once a termination condition trips; here the iterations are a
Python loop that reads the score and the two norms back once per
iteration and stops updating once it is done, giving the same params and
the same per-iteration scores. The line-searched, conjugate-gradient,
LBFGS and Hessian-free solvers are not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

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

    grad_and_score(params) -> (grads tree, scalar score tensor)
    score(params) -> scalar score tensor
    """

    grad_and_score: Callable
    score: Callable


def from_loss(loss_fn: Callable) -> Objective:
    """An Objective from a loss `(params) -> scalar tensor`: gradients by
    autograd with respect to every leaf of the params tree."""

    def grad_and_score(params):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        with torch.enable_grad():
            s = loss_fn(tree_unflatten(params, leaves))
        grads = torch.autograd.grad(s, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, leaves)]
        return tree_unflatten(params, grads), s.detach()

    def score(params):
        with torch.no_grad():
            return loss_fn(params)

    return Objective(grad_and_score=grad_and_score, score=score)


def make_termination(conf):
    """The termination predicate from conf: any of "eps" (a plateau,
    |score - old_score| < termination_eps), "norm2" (gradient norm below
    termination_norm2) and "zero_direction" (step norm below 1e-12); an
    empty tuple never terminates early."""
    conds = tuple(getattr(conf, "termination_conditions", ("eps", "norm2"))
                  or ())
    eps = getattr(conf, "termination_eps", EPS_TERMINATION)
    n2 = getattr(conf, "termination_norm2", NORM2_TERMINATION)

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


def _sgd(objective: Objective, params0, conf):
    """ITERATION_GRADIENT_DESCENT: updater-chain steps, no line search.

    The updater state starts at zero on every call. With
    `conf.fused_updater` the loop carries params and updater state as flat
    buffers (one per dtype); the gradient is still taken on the tree of
    views into them. Once a termination condition trips, params stop
    changing and the remaining iterations report the score there."""
    if getattr(conf, "fused_updater", False):
        spec = make_flat_spec(params0)
        params = flat_ravel(spec, params0)

        def to_tree(p):
            return flat_unravel(spec, p)

        def ravel_grads(g):
            return flat_ravel(spec, g)

        def norm(t):
            return flat_norm(spec, t)

        def adjust(it, g, p, u):
            return adjust_gradient_flat(conf, it, g, p, u, spec)
    else:
        params = params0

        def to_tree(p):
            return p

        def ravel_grads(g):
            return g

        norm = tree_norm

        def adjust(it, g, p, u):
            return adjust_gradient(conf, it, g, p, u)

    upd = init_updater(params)
    terminated = make_termination(conf)
    done, old_score, stall_n, frozen = False, math.inf, 0, None
    scores = []
    for it in range(conf.num_iterations):
        if done:
            if frozen is None:
                frozen = float(objective.score(to_tree(params)))
            scores.append(frozen)
            continue
        grads, score = objective.grad_and_score(to_tree(params))
        grads = ravel_grads(grads)
        adj, upd = adjust(it, grads, params, upd)
        gnorm, dnorm = norm(grads), norm(adj)
        # direction -adj, alpha fixed at 1; the step function applies
        params = tree_map(lambda p, a: apply_step(conf, p, -a.to(p.dtype),
                                                  1.0), params, adj)
        # the one read-back of the iteration
        s, gn, dn = torch.stack([score.float(), gnorm, dnorm]).tolist()
        scores.append(s)
        stall, hard = terminated(s, old_score, gn, dn)
        stall_n = stall_n + 1 if stall else 0
        done = hard or stall_n >= STALL_PATIENCE
        old_score = s
    return to_tree(params), np.asarray(scores, np.float32), ()


def optimize_with_aux(objective: Objective, params0, conf):
    """Run the configured solver: (params, per-iteration scores, aux). The
    aux channel (BatchNorm moments in the JAX package) is always () here."""
    algo = OptimizationAlgorithm(str(conf.optimization_algo))
    if algo == OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT:
        return _sgd(objective, params0, conf)
    raise NotImplementedError(
        f"optimization algorithm '{algo}' is not ported to "
        f"deeplearning4j_tpu_torch yet; see ROADMAP.md queue A item 9")


def optimize(objective: Objective, params0, conf):
    """Run the configured solver; returns (params, per-iteration scores)."""
    params, scores, _ = optimize_with_aux(objective, params0, conf)
    return params, scores
