"""Backtracking line search.

Counterpart of `deeplearning4j_tpu/optimize/linesearch.py`: the Armijo
sufficient-decrease constant `ALF` (BackTrackLineSearch.java:72), the
direction clamped to `STPMAX * max(|x|, 1)`, and geometric backtracking
(halve the step) for at most `max_iters` halvings. A search in which no
step meets Armijo returns (0, f0): the caller keeps its params.

`backtrack` is the whole search as a host loop: it reads the Armijo test
back after each probe, so it makes exactly the probes of the JAX
package's `lax.while_loop` (one at the initial step, one per halving).
The line-searched solver runs the same steps as separate device segments
(`optimize/solver.py` `LineSearchRun`) from `prepare`, `probe_point` and
`armijo`, so both forms do the same arithmetic.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

ALF = 1e-4  # sufficient-decrease constant (BackTrackLineSearch.java:72)
STPMAX = 100.0


def prepare(x: torch.Tensor, direction: torch.Tensor, grad: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the direction clamped to STPMAX * max(|x|, 1), the slope
    <grad, clamped direction>)."""
    dnorm = torch.linalg.vector_norm(direction)
    stpmax = STPMAX * torch.clamp_min(torch.linalg.vector_norm(x), 1.0)
    direction = torch.where(dnorm > stpmax, direction * (stpmax / dnorm),
                            direction)
    return direction, torch.dot(grad, direction)


def probe_point(x: torch.Tensor, alpha: torch.Tensor,
                direction: torch.Tensor) -> torch.Tensor:
    return x + alpha * direction


def armijo(alpha: torch.Tensor, f_alpha: torch.Tensor, f0: torch.Tensor,
           slope: torch.Tensor) -> torch.Tensor:
    """f(x + alpha d) <= f0 + ALF * alpha * slope, as a bool tensor."""
    return f_alpha <= f0 + ALF * alpha * slope


def backtrack(score_fn: Callable, x: torch.Tensor, direction: torch.Tensor,
              grad: torch.Tensor, f0, max_iters: int = 20,
              initial_step=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find alpha with f(x + alpha*d) <= f0 + ALF*alpha*<g, d>: (alpha,
    f_new) as 0-d tensors, (0, f0) when no step of the `max_iters + 1`
    tried meets it. score_fn: flat vector -> scalar tensor."""
    f0 = torch.as_tensor(f0, dtype=x.dtype, device=x.device)
    direction, slope = prepare(x, direction, grad)
    alpha = torch.as_tensor(initial_step, dtype=x.dtype, device=x.device)
    f_alpha = score_fn(probe_point(x, alpha, direction))
    it = 0
    while not bool(armijo(alpha, f_alpha, f0, slope)) and it < max_iters:
        alpha = alpha * 0.5
        f_alpha = score_fn(probe_point(x, alpha, direction))
        it += 1
    ok = armijo(alpha, f_alpha, f0, slope)
    return (torch.where(ok, alpha, torch.zeros_like(alpha)),
            torch.where(ok, f_alpha, f0))
