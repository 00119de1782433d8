"""Iteration listeners.

Counterpart of `deeplearning4j_tpu/optimize/listeners.py`: a listener sees
each iteration's score after a solver run, replayed from the run's score
array by `dispatch`.
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    def iteration_done(self, model, iteration: int, score: float) -> None:
        raise NotImplementedError


class ScoreIterationListener(IterationListener):
    """Logs the score every `print_iterations` iterations."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration, score):
        if iteration % self.print_iterations == 0:
            log.info("Score at iteration %d is %s", iteration, score)


def dispatch(listeners, model, scores) -> None:
    """Replay per-iteration scores from a finished solver run. A run that
    terminated early ends in a run of equal scores (the solver reports the
    frozen score); only the first of them is replayed. Non-finite scores
    are skipped."""
    if not listeners:
        return
    scores = np.asarray(scores)
    end = len(scores)
    if end > 1:
        last = scores[-1]
        i = end - 1
        while i > 0 and scores[i - 1] == last:  # nan-safe: nan != nan
            i -= 1
        if end - i >= 2:  # a run of >= 2 equal scores = frozen tail
            end = i + 1
    for i in range(end):
        s = scores[i]
        if not np.isfinite(s):
            continue
        for listener in listeners:
            listener.iteration_done(model, i, float(s))
