"""The precision eval harness and the int8 calibration of the attention
and reconstruction models of `precision_eval_confs(small=True)`
(char_transformer, deep_autoencoder) against the JAX package's:
`tests/torch_budget_support.py` says what is checked."""

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

from torch_budget_support import check_model, jax_run  # noqa: E402


@pytest.mark.parametrize("model", ["char_transformer", "deep_autoencoder"])
def test_budget_verdicts_and_calibration_are_jaxs(model, monkeypatch):
    check_model(model, jax_run(model), monkeypatch)
