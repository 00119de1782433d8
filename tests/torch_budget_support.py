"""Shared by `tests/test_torch_budgets_*.py`: one model's precision
budget report in the JAX package, with the forwards and the calibration it
ran recorded, and the port's checks against it.

For each model of `precision_eval_confs(small=True)`: the port's
`within_budget` verdicts are JAX's; the port's calibration, answered by the
forwards JAX's report ran (on the port's quantized trees, which are bitwise
JAX's), gives the clip, MSE and report of JAX's calibration and its
quantized tree; and on its own forwards the port's clip is one of the
grid's and within the model's int8 budget (which one depends on the
bfloat16 rounding of the forwards at these widths, ROADMAP.md queue C).
The models are split over two files to keep each under a minute.
"""

import hashlib

import jax
import numpy as np
import torch

from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import quantize as jq
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import quantize
from deeplearning4j_tpu_torch.parallel import checkpoint


def _x_digest(x) -> str:
    a = np.ascontiguousarray(np.asarray(x))
    return hashlib.sha256(str(a.shape).encode() + a.tobytes()).hexdigest()


def jax_run(model: str) -> dict:
    """JAX's `error_budget_report(small=True)` of `model` alone, its
    forwards recorded by (params digest, input digest, policy) and its
    calibration's (quantized tree's digest, report)."""
    confs = jax_zoo.precision_eval_confs(small=True)
    forwards, calibrations = {}, []
    saved = (jq.policy_output, jq.calibrate_int8,
             jax_zoo.precision_eval_confs)
    policy_output, calibrate = saved[0], saved[1]

    def record_forward(conf, params, x, policy):
        out = policy_output(conf, params, x, policy)
        forwards[(jq.params_digest(params), _x_digest(x), policy)] = \
            np.asarray(out)
        return out

    def record_calibration(conf, params, x, *args):
        q, rep = calibrate(conf, params, x, *args)
        calibrations.append((jq.params_digest(q), rep))
        return q, rep

    jq.policy_output, jq.calibrate_int8 = record_forward, record_calibration
    jax_zoo.precision_eval_confs = lambda small=True: {model: confs[model]}
    try:
        report = jq.error_budget_report(small=True)
    finally:
        (jq.policy_output, jq.calibrate_int8,
         jax_zoo.precision_eval_confs) = saved
    return {"report": report[model], "forwards": forwards,
            "calibration": calibrations[0], "conf": confs[model]}


def check_model(model: str, run: dict, monkeypatch) -> None:
    """The port against `jax_run(model)`: verdicts, budgets, calibration."""
    jconf = run["conf"]
    jnet = JaxNet(jconf, seed=0).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu", seed=0)
    net.params = checkpoint.params_from_numpy(jax.device_get(jnet.params),
                                              "cpu")
    x = torch.from_numpy(quantize.default_calibration(net.conf, rows=32,
                                                      seed=2))
    _, own = quantize.calibrate_int8(net.conf, net.params, x)
    budgets = zoo.PRECISION_ERROR_BUDGETS[model]
    assert own["clip"] in quantize.CLIP_GRID
    assert own["rel_mse"] <= budgets["int8"]["rel_mse"]

    confs = zoo.precision_eval_confs(small=True)
    monkeypatch.setattr(zoo, "precision_eval_confs",
                        lambda small=True: {model: confs[model]})
    port = quantize.error_budget_report(small=True, device="cpu")[model]
    for policy, row in run["report"].items():
        assert port[policy]["within_budget"] == row["within_budget"], (
            model, policy, port[policy], row)
        assert port[policy]["budget"] == row["budget"] == budgets[policy]
    quantize.assert_error_budgets({model: port})

    seen = run["forwards"]
    monkeypatch.setattr(quantize, "policy_output", lambda conf, params, x,
                        policy: torch.from_numpy(seen[(
                            quantize.params_digest(params), _x_digest(x),
                            policy)]))
    q, rep = quantize.calibrate_int8(net.conf, net.params, x)
    digest, want = run["calibration"]
    assert rep == want
    assert quantize.params_digest(q) == digest
