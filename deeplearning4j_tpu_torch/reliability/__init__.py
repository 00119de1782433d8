"""Resilience vocabulary of the serving and training paths: the circuit
breaker, the retry budget, fault injection and the exceptions the hardened
paths raise. The port's own copies of the JAX package's
`reliability/circuit.py`, `reliability/budget.py`, `reliability/faults.py`,
`DeadlineExceeded` and `TrainingInterrupted`; stdlib only."""

from deeplearning4j_tpu_torch.reliability.budget import RetryBudget
from deeplearning4j_tpu_torch.reliability.circuit import CircuitBreaker
from deeplearning4j_tpu_torch.reliability.faults import (
    REGISTRY,
    FaultInjected,
    FaultPlanError,
    FaultRegistry,
    arm,
    disarm,
    fire,
    hits,
    install_env_plan,
    reset,
    stats,
)


class DeadlineExceeded(TimeoutError):
    """A request's `deadline_ms` elapsed before it produced a result
    (serving maps this to HTTP 504)."""


class TrainingInterrupted(RuntimeError):
    """`fit()` was interrupted (SIGTERM or `request_stop_training`) and
    checkpointed; re-running with the same `checkpoint_dir` resumes where
    it left off."""


__all__ = [
    "CircuitBreaker",
    "DeadlineExceeded",
    "FaultInjected",
    "FaultPlanError",
    "FaultRegistry",
    "REGISTRY",
    "RetryBudget",
    "TrainingInterrupted",
    "arm",
    "disarm",
    "fire",
    "hits",
    "install_env_plan",
    "reset",
    "stats",
]
