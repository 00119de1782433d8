"""The solvers: stepped gradient descent, the line-searched GD, CG and
LBFGS, and Hessian-free.

Counterpart of `deeplearning4j_tpu/optimize/solver.py`, which runs every
solver as one `lax.scan` and masks the updates once a termination
condition trips. Dispatch by `conf.optimization_algo`, as `_optimize_impl`
dispatches (`optimize`, `optimize_with_aux`):

- ITERATION_GRADIENT_DESCENT: `_sgd`, a Python loop that reads the score
  and the two norms back once per iteration and stops updating once it is
  done (the eager path), and `sgd_device`, which keeps that state on the
  device and masks as the scan does, so that one CUDA graph holds the run
  (`optimize/step_cache.py`). Both give the same params and scores.
- GRADIENT_DESCENT, CONJUGATE_GRADIENT (Polak-Ribiere, restarted on a
  non-descent direction), LBFGS (two-loop recursion over `lbfgs_memory`
  pairs): `LineSearchRun`. The backtracking search is a data-dependent
  loop, so one graph cannot hold the run: an iteration is three device
  segments (the gradient, direction and first probe; one halving and its
  probe; the step and the termination update) over state tensors that
  stay in place, and the host reads one small tensor after each probe
  (Armijo met or the halvings spent, the termination verdict, the score).
  So an iteration makes exactly the probes of the JAX package's
  `backtrack`, and once the run is done nothing more runs on the device
  (the remaining scores are the last one, as the masked scan reports).
  The step cache captures each segment as a CUDA graph and replays them;
  the eager path (`_line_searched`) runs the same arithmetic with
  `linesearch.backtrack` as the search, and gives the same bits.
- HESSIAN_FREE: `_hessian_free`, damped inner CG with a fixed trip count
  and masks, as in the scan, so one graph holds it too. Curvature products
  are Gauss-Newton (`from_predict_loss`: J^T H_L J v by `torch.func.jvp`
  and `vjp`) or, without a factored objective, the exact Hessian-vector
  product of the objective's `loss`. A layer whose forward is a
  `torch.autograd.Function` without forward-mode derivatives cannot be
  differentiated that way: `check_jvp` names it.

The line-searched solvers and Hessian-free work on the flat parameter
vector in `ravel_pytree`'s order (`optimize/tree.ravel_tree`), so LBFGS
histories and CG vectors are the JAX package's.

Keys: an objective takes `(params, key)`. With a key (an int64 [2] tensor)
the solver splits it once per iteration, `k, sub = split(k)`, and hands
`sub` to the objective, as JAX's scan does; a line search's probes reuse
the iteration's key. Without one (nothing is drawn) nothing is split.

Aux: an objective with `grad_score_aux` also returns an aux tree from its
forward (the BatchNorm moments); the solvers keep the aux of the last
iteration that ran live, as JAX masks it, and return it beside the params
(`optimize_with_aux`).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nn.conf import OptimizationAlgorithm
from deeplearning4j_tpu_torch.optimize import linesearch
from deeplearning4j_tpu_torch.optimize.tree import (ravel_tree, tree_leaves,
                                                    tree_map, tree_unflatten)
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
    gnvp(params, v tree, key) -> tree, or None: the Gauss-Newton
        curvature-vector product for Hessian-free
    grad_score_aux(params, key=None) -> (grads, score, aux tree), or None
    loss(params, key) -> differentiable scalar, or None: what
        Hessian-free takes the exact Hessian-vector product of when there
        is no `gnvp` (an objective built from a loss has it)
    """

    grad_and_score: Callable
    score: Callable
    gnvp: Optional[Callable] = None
    grad_score_aux: Optional[Callable] = None
    loss: Optional[Callable] = None


class BatchedObjective(NamedTuple):
    """An Objective whose callables take the batch explicitly, `(params,
    x, y, key)`, as the JAX package's compiled train steps take it."""

    grad_and_score: Callable                 # (params, x, y, key) -> (g, s)
    score: Callable                          # (params, x, y, key) -> s
    gnvp: Optional[Callable] = None          # (params, v, x, y, key) -> tree
    grad_score_aux: Optional[Callable] = None  # (params, x, y, key) -> 3
    loss: Optional[Callable] = None          # (params, x, y, key) -> s

    def bind(self, x, y) -> "Objective":
        """The Objective of one batch."""
        def opt(f, wrap):
            return None if f is None else wrap(f)

        return Objective(
            grad_and_score=lambda p, k=None: self.grad_and_score(p, x, y, k),
            score=lambda p, k=None: self.score(p, x, y, k),
            gnvp=opt(self.gnvp,
                     lambda f: lambda p, v, k=None: f(p, v, x, y, k)),
            grad_score_aux=opt(self.grad_score_aux,
                               lambda f: lambda p, k=None: f(p, x, y, k)),
            loss=opt(self.loss, lambda f: lambda p, k=None: f(p, x, y, k)))


def batched_from_loss(loss_fn: Callable) -> BatchedObjective:
    """A BatchedObjective from a loss `(params, x, y, key) -> scalar`."""

    def grad_and_score(params, x, y, key=None):
        g, s, _ = _grads(lambda p, k: (loss_fn(p, x, y, k), ()), params, key)
        return g, s

    def score(params, x, y, key=None):
        with torch.no_grad():
            return loss_fn(params, x, y, key)

    return BatchedObjective(grad_and_score=grad_and_score, score=score,
                            loss=loss_fn)


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

    return Objective(grad_and_score=grad_and_score, score=score, loss=call)


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
        score=score, grad_score_aux=grad_score_aux,
        loss=lambda p, key=None: loss_fn(p, key)[0])


def from_predict_loss(predict: Callable, loss_of_out: Callable) -> Objective:
    """An Objective from `predict(params, key) -> outputs` and
    `loss_of_out(outputs) -> scalar`, with the Gauss-Newton product
    G v = J^T (H_L (J v)): J v by `torch.func.jvp` of predict, H_L (J v) by
    the jvp of the loss's gradient at the outputs, J^T by `vjp`."""

    def loss_fn(params, key=None):
        return loss_of_out(predict(params, key))

    def gnvp(params, v, key=None):
        def f(p):
            return predict(p, key)

        z, jz = torch.func.jvp(f, (params,), (v,))
        hl_jz = torch.func.jvp(torch.func.grad(loss_of_out), (z,), (jz,))[1]
        return torch.func.vjp(f, params)[1](hl_jz)[0]

    return from_loss(loss_fn, with_key=True)._replace(gnvp=gnvp)


def weighted_predict_loss(predict: Callable, rowwise_loss: Callable, labels,
                          row_weights) -> Objective:
    """`from_predict_loss` with the row weights (pad rows 0) in the loss of
    the outputs: the weighted mean of `rowwise_loss(labels, z)`, so that a
    pad row's curvature cotangent is an exact zero and a padded batch
    gives the unpadded batch's Gauss-Newton products."""

    def loss_of_out(z):
        rows = rowwise_loss(labels, z)
        return torch.dot(rows, row_weights) / torch.clamp_min(
            row_weights.sum(), 1.0)

    return from_predict_loss(predict, loss_of_out)


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


def _device_verdict(conds, eps, n2, score, old_score, gnorm, dnorm):
    """(stall, hard) as bool tensors on the device: `make_termination`'s
    predicate, decided in f32 as the scan decides it."""
    hard = torch.zeros((), dtype=torch.bool, device=score.device)
    if "norm2" in conds:
        hard = hard | (gnorm < n2)
    if "zero_direction" in conds:
        hard = hard | (dnorm < 1e-12)
    stall = (torch.abs(score - old_score) < eps if "eps" in conds
             else torch.zeros_like(hard))
    return stall, hard


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


def _ravel(tree, dtype) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(dtype) for t in tree_leaves(tree)])


class LineSearchRun:
    """One GD / CG / LBFGS run as device segments over state tensors that
    stay in place, and the host loop that drives them.

    `setup(params0, key)` allocates the state (outside any capture);
    `segments` maps each segment's name to a function of no arguments:
      init    the flat x from the params tree `params0` (read anew on
              every run, so a captured init reads the network's tensors)
              and the carry's initial values, the key from `key`;
      start   split the key; the gradient and score at x; the LBFGS pair;
              the direction; the clamp and slope; the first probe at
              clip(2 * prev_alpha, 1e-3, 1e6);
      halve   alpha / 2 and its probe;
      finish  the accepted step (alpha 0 when no probe met Armijo), the
              carry and the stall count.
    `start` and `halve` return the probe's verdict, a float32 [3] tensor
    (search over, done after it, the iteration's score), the one tensor the
    host reads per probe. `drive(call)` runs a whole solve through `call(
    name) -> the segment's output` and returns the per-iteration scores;
    `books` counts its probes and reads. After a run, `flat` holds the
    params and `aux` the last iteration's aux.
    """

    def __init__(self, objective: Objective, conf, algo):
        self.objective = objective
        self.conf = conf
        self.algo = OptimizationAlgorithm(str(algo))
        self.conds, self.eps, self.n2 = _termination_settings(conf)
        self.m = conf.lbfgs_memory
        self.max_iters = conf.num_line_search_iterations
        self.segments = {"init": self._init, "start": self._start,
                         "halve": self._halve, "finish": self._finish}
        self.books = {"probes": [], "reads": 0}  # of the last `drive`

    def setup(self, params0, key=None) -> None:
        self.params0, self.key_in = params0, key
        flat, self.unravel = ravel_tree(params0)
        n, dt, dev = flat.shape[0], flat.dtype, flat.device
        self.dtype = dt

        def vec():
            return torch.zeros(n, dtype=dt, device=dev)

        def scalar(dtype=torch.float32):
            return torch.zeros((), dtype=dtype, device=dev)

        # the carry of JAX's scan, and this iteration's search
        self.flat, self.x_prev, self.g_prev, self.d_prev = (vec(), vec(),
                                                            vec(), vec())
        self.g, self.d, self.dirc = vec(), vec(), vec()
        lbfgs = self.algo == OptimizationAlgorithm.LBFGS
        hist = (self.m, n) if lbfgs else (0, n)
        self.s_hist = torch.zeros(hist, dtype=dt, device=dev)
        self.y_hist = torch.zeros(hist, dtype=dt, device=dev)
        self.hist_n = scalar(torch.int64)
        self.k = None if key is None else key.clone()
        self.kg = None if key is None else key.clone()
        self.old_score, self.stall_n = scalar(), scalar(torch.int64)
        self.prev_alpha, self.alpha = scalar(dt), scalar(dt)
        self.f_alpha, self.f0, self.slope = scalar(), scalar(), scalar(dt)
        self.gnorm, self.dnorm = scalar(dt), scalar(dt)
        self.ls_it = scalar(torch.int64)
        self.aux = _aux_zeros(self.objective, params0, key)

    # -- the objective on the flat vector --------------------------------
    def _grad_flat(self, x, k):
        g, s, aux = _grad_score_aux(self.objective, self.unravel(x), k)
        return _ravel(g, self.dtype), s.float(), aux

    def _score_flat(self, x, k):
        return self.objective.score(self.unravel(x), k).float()

    # -- segments ----------------------------------------------------------
    def _init(self):
        self.flat.copy_(_ravel(self.params0, self.dtype))
        self.x_prev.copy_(self.flat)
        for t in (self.g_prev, self.d_prev, self.s_hist, self.y_hist,
                  self.hist_n, self.stall_n):
            t.zero_()
        if self.k is not None:
            self.k.copy_(self.key_in)
        self.old_score.fill_(math.inf)
        self.prev_alpha.fill_(0.5)

    def _direction(self, g):
        if self.algo == OptimizationAlgorithm.CONJUGATE_GRADIENT:
            # Polak-Ribiere: beta = max(0, g.(g - g_prev) / g_prev.g_prev)
            denom = torch.dot(self.g_prev, self.g_prev)
            beta = torch.where(
                denom > 0, torch.clamp_min(
                    torch.dot(g, g - self.g_prev) / denom, 0.0),
                torch.zeros_like(denom))
            d = -g + beta * self.d_prev
            return torch.where(torch.dot(d, g) < 0, d, -g)
        if self.algo == OptimizationAlgorithm.LBFGS:
            return self._lbfgs_direction(g)
        return -g

    def _lbfgs_direction(self, g):
        """The two-loop recursion after pushing the pair (x - x_prev, g -
        g_prev) where s.y > 1e-10 (valid pairs at m-hist_n..m-1, newest
        last). JAX also asks `it > 0`: at the first iteration x_prev is x
        and s is exactly 0, so s.y > 1e-10 already fails there."""
        m, x = self.m, self.flat
        s_vec, y_vec = x - self.x_prev, g - self.g_prev
        have = torch.dot(s_vec, y_vec) > 1e-10
        self.s_hist.copy_(torch.where(
            have, torch.cat([self.s_hist[1:], s_vec[None]]), self.s_hist))
        self.y_hist.copy_(torch.where(
            have, torch.cat([self.y_hist[1:], y_vec[None]]), self.y_hist))
        self.hist_n.copy_(torch.where(
            have, torch.clamp_max(self.hist_n + 1, m), self.hist_n))
        s_h, y_h, hist_n = self.s_hist, self.y_hist, self.hist_n
        q, loop = g, []
        for i in range(m - 1, -1, -1):  # newest -> oldest
            valid = i >= m - hist_n
            rho = torch.where(valid, 1.0 / (torch.dot(y_h[i], s_h[i])
                                            + 1e-10), 0.0)
            a_i = rho * torch.dot(s_h[i], q)
            q = q - torch.where(valid, a_i, 0.0) * y_h[i]
            loop.append((i, a_i, rho, valid))
        sy = torch.dot(s_h[m - 1], y_h[m - 1])
        yy = torch.dot(y_h[m - 1], y_h[m - 1])
        gamma = torch.where((hist_n > 0) & (yy > 0), sy / yy, 1.0)
        r = gamma * q
        for i, a_i, rho, valid in reversed(loop):  # oldest -> newest
            b_i = rho * torch.dot(y_h[i], r)
            r = r + torch.where(valid, a_i - b_i, 0.0) * s_h[i]
        d = -r
        return torch.where(torch.dot(d, g) < 0, d, -g)

    def _probe(self):
        return self._score_flat(
            linesearch.probe_point(self.flat, self.alpha, self.dirc),
            self.kg)

    def _begin(self):
        """The iteration up to its search: split the key; the gradient and
        score at x; the direction, its clamp and slope; the trial step."""
        if self.k is not None:
            ks = nd_random.split(self.k)
            self.k.copy_(ks[0])
            self.kg.copy_(ks[1])
        g, score, aux = self._grad_flat(self.flat, self.kg)
        self.aux = aux
        self.g.copy_(g)
        self.gnorm.copy_(torch.linalg.vector_norm(g))
        d = self._direction(g)
        self.d.copy_(d)
        self.dnorm.copy_(torch.linalg.vector_norm(d))
        dirc, slope = linesearch.prepare(self.flat, d, g)
        self.dirc.copy_(dirc)
        self.slope.copy_(slope)
        self.f0.copy_(score)
        self.alpha.copy_(torch.clamp(self.prev_alpha * 2.0, 1e-3, 1e6))
        self.ls_it.zero_()

    def _search_result(self):
        """(accepted step, the iteration's score, Armijo met) of the search
        as it stands: (0, f0) when the last probe missed Armijo, as
        `backtrack` returns."""
        ok = linesearch.armijo(self.alpha, self.f_alpha, self.f0, self.slope)
        return (torch.where(ok, self.alpha, torch.zeros_like(self.alpha)),
                torch.where(ok, self.f_alpha, self.f0), ok)

    def _termination(self, alpha, new_score):
        """(the new stall count, done) after a search that accepted
        `alpha` (0: it failed, a soft stall: the next iteration retries)."""
        stall, hard = _device_verdict(self.conds, self.eps, self.n2,
                                      new_score, self.old_score, self.gnorm,
                                      self.dnorm)
        stall = stall | ~(alpha > 0)
        stall_n = torch.where(stall, self.stall_n + 1, 0)
        return stall_n, hard | (stall_n >= STALL_PATIENCE)

    def _verdict(self):
        alpha, new_score, ok = self._search_result()
        _, done = self._termination(alpha, new_score)
        over = ok | (self.ls_it >= self.max_iters)
        return torch.stack([over.float(), done.float(), new_score])

    def _start(self):
        self._begin()
        self.f_alpha.copy_(self._probe())
        return self._verdict()

    def _halve(self):
        self.alpha.copy_(self.alpha * 0.5)
        self.f_alpha.copy_(self._probe())
        self.ls_it.add_(1)
        return self._verdict()

    def _conclude(self, alpha, new_score):
        """Take the step `alpha` (0 after a failed search) along the
        direction and carry the iteration over; returns done."""
        stall_n, done = self._termination(alpha, new_score)
        x_new = apply_step(self.conf, self.flat, self.d, alpha)
        self.x_prev.copy_(self.flat)
        self.flat.copy_(x_new)
        self.g_prev.copy_(self.g)
        self.d_prev.copy_(self.d)
        self.old_score.copy_(new_score)
        self.stall_n.copy_(stall_n)
        self.prev_alpha.copy_(torch.where(alpha == 0.0, self.prev_alpha,
                                          alpha))
        return done

    def _finish(self):
        alpha, new_score, _ = self._search_result()
        self._conclude(alpha, new_score)

    # -- the host loop -------------------------------------------------------
    def drive(self, call) -> np.ndarray:
        n_iter = self.conf.num_iterations
        scores = []
        self.books = {"probes": [], "reads": 0}
        call("init")
        for _ in range(n_iter):
            over, done, score = call("start").tolist()
            probes = 1
            while not over:
                over, done, score = call("halve").tolist()
                probes += 1
            call("finish")
            self.books["probes"].append(probes)
            self.books["reads"] += probes
            scores.append(score)
            if done:
                # the masked scan reports the last live score from here on
                scores += [score] * (n_iter - len(scores))
                break
        return np.asarray(scores, np.float32)

    def params(self):
        """A new params tree from the flat state."""
        return tree_map(lambda t: t.clone(), self.unravel(self.flat))


def _line_searched(objective: Objective, params0, conf, key=None, algo=None):
    """GD / CG / LBFGS with the Armijo search, eagerly: each iteration
    `LineSearchRun`'s steps up to the search, then `linesearch.backtrack`
    (which reads the Armijo test back after each probe), then the step and
    one read of (done, score). The same arithmetic as the run's segments,
    so the step cache's program gives the same bits. Returns (params,
    scores, aux)."""
    run = LineSearchRun(objective, conf,
                        algo if algo is not None else conf.optimization_algo)
    run.setup(params0, key)
    run.segments["init"]()
    n_iter, scores = conf.num_iterations, []
    for _ in range(n_iter):
        run._begin()
        alpha, new_score = linesearch.backtrack(
            lambda v: run._score_flat(v, run.kg), run.flat, run.d, run.g,
            run.f0, max_iters=run.max_iters, initial_step=run.alpha)
        done = run._conclude(alpha, new_score)
        done, score = torch.stack([done.float(), new_score]).tolist()
        scores.append(score)
        if done:
            scores += [score] * (n_iter - len(scores))
            break
    return run.params(), np.asarray(scores, np.float32), run.aux


# -- Hessian-free --------------------------------------------------------------

#: layer types whose forward can run a `torch.autograd.Function` that
#: defines no forward-mode derivative, and the Function
_NO_JVP = {"convolution": "Conv2dFunction (cuDNN convolution)",
           "attention": "FlashAttentionFunction (the flash kernel)",
           "lstm": "LSTMCellFunction (the fused LSTM cell kernel)",
           "graves_lstm": "LSTMCellFunction (the fused LSTM cell kernel)"}


def check_jvp(conf, cuda: bool) -> None:
    """Raise NotImplementedError naming the first layer of `conf` (a
    MultiLayerConfiguration) whose forward on this device goes through a
    `torch.autograd.Function` without a jvp, which Hessian-free's
    Gauss-Newton products need: convolution always; attention and the
    LSTMs where they take their kernels (on CUDA by default, or asked for
    by `attention_impl="flash"` / `lstm_impl="fused"`)."""
    for i, c in enumerate(conf.confs):
        lt = str(c.layer_type).lower()
        if lt not in _NO_JVP:
            continue
        if lt == "attention":
            impl = c.attention_impl
            blocked = impl == "flash" or (impl == "auto" and cuda)
        elif lt in ("lstm", "graves_lstm"):
            impl = getattr(c, "lstm_impl", "auto")
            blocked = impl == "fused" or (impl == "auto" and cuda)
        else:
            blocked = True
        if blocked:
            raise NotImplementedError(
                f"Hessian-free needs forward-mode derivatives (jvp) of the "
                f"network; layer {i} ({lt}) runs {_NO_JVP[lt]}, which "
                f"defines none (ROADMAP.md queue C)")


def _exact_hvp(objective: Objective, unravel, x, v, k):
    """(Hessian of the objective's loss at x) v, by jvp over grad."""
    if objective.loss is None:
        raise NotImplementedError(
            "Hessian-free needs the objective's loss (for the exact "
            "Hessian-vector product) or a Gauss-Newton product (gnvp); "
            "this objective gives only its gradient (an RBM's CD-k)")
    return torch.func.jvp(
        torch.func.grad(lambda xx: objective.loss(unravel(xx), k)), (x,),
        (v,))[1]


def _hessian_free(objective: Objective, params0, conf, key=None):
    """Martens Hessian-free, graph-safe: every iteration runs, masked once
    done, as the scan does. Per iteration: the gradient; CG on (B + lam I)
    d = -g for `hf_cg_iterations` trips from 0.95 d_prev, each trip masked
    once its residual or curvature vanishes; the quadratic model's
    reduction; the proposal x + d scored; the Levenberg-Marquardt lam
    from rho (x 2/3 above 0.75, x 1.5 below 0.25); accepted only if it
    lowers the score. A rejected iteration reports the score at x.
    Returns (params, scores [num_iterations] tensor, aux)."""
    x, unravel = ravel_tree(params0)
    dt = x.dtype
    conds, eps, n2 = _termination_settings(conf)

    def grad_flat_aux(xx, k):
        g, s, aux = _grad_score_aux(objective, unravel(xx), k)
        return _ravel(g, dt), s.float(), aux

    def bvp(xx, v, lam, k):
        """The damped curvature-vector product (B + lam I) v."""
        if objective.gnvp is not None:
            hv = _ravel(objective.gnvp(unravel(xx), unravel(v), k), dt)
        else:
            hv = _exact_hvp(objective, unravel, xx, v, k)
        return hv + lam * v

    def cg_solve(xx, g, lam, d0, k):
        r = -g - bvp(xx, d0, lam, k)
        d, p, rs = d0, r, torch.dot(r, r)
        for _ in range(conf.hf_cg_iterations):
            ap = bvp(xx, p, lam, k)
            denom = torch.dot(p, ap)
            live = (rs > 1e-16) & (denom > 1e-20)
            alpha = torch.where(live, rs / torch.where(denom == 0, 1.0,
                                                       denom), 0.0)
            d = d + alpha * p
            r = r - alpha * ap
            rs_new = torch.dot(r, r)
            beta = torch.where(live, rs_new / torch.where(rs == 0, 1.0, rs),
                               0.0)
            p = torch.where(live, r + beta * p, p)
            rs = torch.where(live, rs_new, rs)
        return d

    d_prev = torch.zeros_like(x)
    # made on the device (a copy from the host cannot be captured)
    lam = torch.full((), conf.hf_initial_lambda, device=x.device)
    done = torch.zeros((), dtype=torch.bool, device=x.device)
    old_score = torch.full((), math.inf, device=x.device)
    stall_n = torch.zeros((), dtype=torch.int64, device=x.device)
    aux = _aux_zeros(objective, params0, key)
    scores, k = [], key
    for _ in range(conf.num_iterations):
        k, kg = _split_key(k)
        g, score, aux_new = grad_flat_aux(x, kg)
        aux = tree_map(lambda o, n: torch.where(done, o, n), aux, aux_new)
        gnorm = torch.linalg.vector_norm(g)
        d = cg_solve(x, g, lam, 0.95 * d_prev, kg)
        # the quadratic model's reduction, for the LM rho test
        qm = torch.dot(g, d) + 0.5 * torch.dot(d, bvp(x, d, lam, kg))
        proposal = apply_step(conf, x, d, 1.0)
        new_score = objective.score(unravel(proposal), kg).float()
        rho = (new_score - score) / torch.where(qm >= 0, -1e-10, qm)
        lam = torch.where(rho > 0.75, lam * (2.0 / 3.0),
                          torch.where(rho < 0.25, lam * 1.5, lam))
        accept = new_score < score
        x = torch.where(done | ~accept, x, proposal)
        d_prev = torch.where(done, d_prev, d)
        out = torch.where(done, old_score,
                          torch.where(accept, new_score, score))
        stall, hard = _device_verdict(conds, eps, n2, new_score, old_score,
                                      gnorm, torch.linalg.vector_norm(d))
        stall_n = torch.where(done, stall_n,
                              torch.where(stall, stall_n + 1, 0))
        done = done | hard | (stall_n >= STALL_PATIENCE)
        old_score = out
        scores.append(out)
    return (unravel(x), torch.stack(scores) if scores
            else torch.zeros(0, device=x.device), aux)


# -- dispatch ----------------------------------------------------------------

def optimize_with_aux(objective: Objective, params0, conf, key=None):
    """Run the configured solver: (params, per-iteration scores as float32
    numpy, aux), aux the objective's aux of the last live iteration (the
    BatchNorm moments), () for an objective without one."""
    algo = OptimizationAlgorithm(str(conf.optimization_algo))
    if algo == OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT:
        return _sgd(objective, params0, conf, key)
    if algo == OptimizationAlgorithm.HESSIAN_FREE:
        params, scores, aux = _hessian_free(objective, params0, conf, key)
        return params, scores.cpu().numpy(), aux
    return _line_searched(objective, params0, conf, key, algo)


def optimize(objective: Objective, params0, conf, key=None):
    """Run the configured solver; returns (params, per-iteration scores)."""
    params, scores, _ = optimize_with_aux(objective, params0, conf, key)
    return params, scores


class Solver:
    """The reference's `Solver` as an object: a conf and an objective,
    `optimize(params, key)` the configured solver over them (`optimize`).
    The params' device is the device the solver runs on."""

    def __init__(self, conf, objective: Objective):
        self.conf = conf
        self.objective = objective

    def optimize(self, params, key=None):
        return optimize(self.objective, params, self.conf, key)
