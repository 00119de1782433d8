"""Iteration listeners.

Counterpart of `deeplearning4j_tpu/optimize/listeners.py`: a listener sees
each iteration's score after a solver run, replayed from the run's score
array by `dispatch`. `ScoreIterationListener` logs, `CheckpointListener`
saves the network every N iterations (asynchronously by default, from a
host snapshot taken at the iteration; a data-parallel trainer's state
with its updater and mesh), and `ComposableIterationListener`
fans one iteration out to several listeners.
"""

from __future__ import annotations

import logging
from typing import Sequence

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


class CheckpointListener(IterationListener):
    """Save the model to `directory` every `save_every_n` iterations,
    through `checkpoint.save_async` (`asynchronous`, the default: the
    snapshot is taken on the training thread, the write runs on another)
    or `checkpoint.save`. Given a `DataParallelTrainer` it saves the
    trainer's params, updater state (gathered whole under ZeRO-1) and step
    with its mesh record, as the JAX package's does; given a network, its
    params and conf, with the iteration as the step. `wait()` blocks until
    the last write has landed."""

    def __init__(self, directory: str, save_every_n: int = 10,
                 asynchronous: bool = True):
        self.directory = directory
        self.save_every_n = max(1, save_every_n)
        self.asynchronous = asynchronous
        self.saves = 0
        self._last_thread = None

    def iteration_done(self, model, iteration, score):
        if iteration % self.save_every_n != 0:
            return
        from deeplearning4j_tpu_torch.parallel import checkpoint

        net = getattr(model, "net", model)
        conf = getattr(net, "conf", None)
        meta = {"score": float(score)}
        if callable(getattr(model, "checkpoint_state", None)):
            params, updater, step = model.checkpoint_state()
            args = (self.directory, params, updater)
            # the writing topology, so that a loader detects an elastic
            # (n -> m ranks) resume instead of guessing
            kw = dict(conf=conf, step=step, metadata=meta,
                      mesh=model.mesh_meta())
        else:
            args = (self.directory, net.params, None)
            kw = dict(conf=conf, step=int(iteration), metadata=meta)
        if self.asynchronous:
            self._last_thread = checkpoint.save_async(*args, **kw)
        else:
            checkpoint.save(*args, **kw)
        self.saves += 1

    def wait(self) -> None:
        """Block until the last asynchronous save has landed."""
        if self._last_thread is not None:
            self._last_thread.join()


class ComposableIterationListener(IterationListener):
    """Hands each iteration to every listener in `listeners`, in order."""

    def __init__(self, listeners: Sequence[IterationListener]):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration, score):
        for listener in self.listeners:
            listener.iteration_done(model, iteration, score)


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
