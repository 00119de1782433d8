"""Serve-path precision policies: f32, bf16 and int8 weight-only.

Counterpart of `deeplearning4j_tpu/optimize/quantize.py`:

  "f32"   the default: nothing changes, and the serve path's keys and
          outputs are bitwise the pre-policy ones.
  "bf16"  cast-on-load: every float leaf cast to bfloat16 once, every
          layer's compute dtype bfloat16 (`conf.with_compute_dtype`), the
          program's output cast back to float32.
  "int8"  weight-only per-channel symmetric quantization: each `W*` leaf
          of two or more dims held as int8 `q` and a float32 `scale` per
          output channel, dequantized to bfloat16 inside the program
          (`q.to(bf16) * scale.to(bf16)`, the JAX package's order of
          casts); the other float leaves go to bfloat16 there too. The
          clip ratio is calibrated on a held-out batch (`calibrate_int8`).

Quantization runs as torch ops on the params' device and is bitwise the
JAX package's numpy: an abs-max per channel, `amax * clip / 127` in
float32 (both divisions tensor by tensor, IEEE on the card too) and
`torch.round` (half to even, as `np.rint`), clipped to +-127.
`params_digest` hashes the leaves as numpy arrays in JAX's leaf order
(dict keys sorted; bfloat16 as `ml_dtypes` spells it), so both packages
name one params tree alike, and `pack_quantized` writes the JAX package's
npz layout.

`error_budget_report` is the eval harness: the four models of
`zoo.precision_eval_confs` under each policy against
`zoo.PRECISION_ERROR_BUDGETS`, from seeded params and seeded batches,
with eager forwards only.
"""

from __future__ import annotations

import hashlib
import io
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

#: the serve-path precision policies, weakest to strongest compression
POLICIES = ("f32", "bf16", "int8")

#: the clip ratios the int8 calibration tries (1.0 is the pure abs-max)
CLIP_GRID = (1.0, 0.999, 0.995, 0.98)


def validate_policy(policy: str) -> str:
    if policy not in POLICIES:
        raise ValueError(f"unknown precision policy {policy!r} "
                         f"(choose one of {', '.join(POLICIES)})")
    return policy


def serve_conf(conf, policy: str):
    """The conf a policy's programs run: every layer's compute dtype
    bfloat16. The key keeps the original conf's fingerprint; the policy is
    a key element of its own."""
    if policy == "f32":
        return conf
    return conf.with_compute_dtype("bfloat16")


def _is_float(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def cast_params_bf16(params) -> tuple:
    """Every float leaf cast to bfloat16 (the others passed through)."""
    return tuple({name: (leaf.to(torch.bfloat16) if _is_float(leaf)
                         else leaf)
                  for name, leaf in layer.items()} for layer in params)


# -- int8 weight-only quantization ------------------------------------------

def _quantizable(name: str, leaf) -> bool:
    """Leaves named W* with >= 2 dims: dense, LSTM, embedding and conv `W`,
    attention `Wqkv` / `Wo`, FFN `W1` / `W2`. Biases, layer-norm and
    batch-norm vectors, `RW` and the positional table `P` stay float."""
    return name.startswith("W") and _is_float(leaf) and leaf.dim() >= 2


def _channel_axis(w) -> int:
    """The per-channel axis: axis 0 of a 4-D (OIHW) conv kernel, the last
    axis (n_out) otherwise."""
    return 0 if w.dim() == 4 else w.dim() - 1


def _quantize_leaf(leaf, clip: float) -> Dict[str, torch.Tensor]:
    """{"q": int8, "scale": float32} of one leaf, keepdims scales."""
    w = torch.as_tensor(leaf).detach().float()
    axis = _channel_axis(w)
    dims = tuple(a for a in range(w.dim()) if a != axis)
    amax = w.abs().amax(dim=dims, keepdim=True)
    # a tensor divisor: CUDA divides by a scalar through its reciprocal,
    # which rounds otherwise than numpy's division
    scale = torch.where(amax > 0.0,
                        (amax * clip) / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "scale" in leaf


def quantize_params_int8(params, clip: float = 1.0) -> tuple:
    """Per-channel symmetric quantization at a fixed clip ratio: the
    quantizable leaves become {"q", "scale"} sub-dicts, the others are
    copies (the tree is a snapshot of `params`)."""
    with torch.no_grad():
        return tuple({name: (_quantize_leaf(leaf, clip)
                             if _quantizable(name, leaf) else leaf.clone())
                      for name, leaf in layer.items()} for layer in params)


def runtime_params(params, policy: str):
    """The params as a policy's program reads them: int8 sub-dicts
    dequantized to bfloat16 (`q.to(bf16) * scale.to(bf16)`) and the other
    float leaves cast to bfloat16; f32 and bf16 trees pass through."""
    if policy != "int8":
        return params
    cd = torch.bfloat16
    out = []
    for layer in params:
        d = {}
        for name, leaf in layer.items():
            if is_quantized(leaf):
                d[name] = leaf["q"].to(cd) * leaf["scale"].to(cd)
            elif _is_float(leaf):
                d[name] = leaf.to(cd)
            else:
                d[name] = leaf
        out.append(d)
    return tuple(out)


def policy_output(conf, params, x, policy: str) -> torch.Tensor:
    """The eager (uncached) forward under `policy`, cast to float32;
    `params` already in the policy's form (cast, or quantized). The
    calibration and evaluation path: it never touches the infer cache."""
    from deeplearning4j_tpu_torch.nn.multilayer import network_output

    with torch.inference_mode():
        return network_output(serve_conf(conf, policy),
                              runtime_params(params, policy), x).float()


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def calibrate_int8(conf, params, x, clip_grid: Tuple[float, ...] = CLIP_GRID):
    """The clip ratio of least output MSE against the f32 forward on the
    held-out batch `x`: (quantized params, report)."""
    ref = _host(policy_output(conf, params, x, "f32"))
    denom = float(np.mean(ref ** 2)) or 1.0
    best = None
    for clip in clip_grid:
        q = quantize_params_int8(params, clip)
        out = _host(policy_output(conf, q, x, "int8"))
        mse = float(np.mean((out - ref) ** 2))
        if best is None or mse < best[1]:
            best = (q, mse, clip)
        del q
    qparams, mse, clip = best
    return qparams, {"clip": clip, "mse": mse, "rel_mse": mse / denom,
                     "calibration_rows": int(x.shape[0])}


# -- persistence --------------------------------------------------------------

def _leaves(tree):
    """The leaves in JAX's `tree_leaves` order (dict keys sorted)."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def params_digest(params) -> str:
    """The JAX package's digest of a params tree (shapes, dtypes, bytes of
    every leaf in its leaf order): ties a stored int8 artifact to the
    weights it came from."""
    from deeplearning4j_tpu_torch.parallel.checkpoint import to_numpy

    h = hashlib.sha256()
    for leaf in _leaves(params):
        a = to_numpy(leaf) if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def quantize_artifact_key(conf_fingerprint: str, digest: str) -> tuple:
    """The store key of an int8 weight artifact."""
    return ("quantized-weights", "int8", conf_fingerprint, digest)


def pack_quantized(qparams, report: Optional[dict] = None) -> bytes:
    """A quantized params tree and its calibration report as one npz blob,
    the JAX package's layout: `n_layers`, `report` (JSON bytes) and one
    array per leaf, named "<layer>|<name>|q", "|s" or "|f"."""
    from deeplearning4j_tpu_torch.parallel.checkpoint import to_numpy

    arrays = {}
    for i, layer in enumerate(qparams):
        for name, leaf in layer.items():
            if is_quantized(leaf):
                arrays[f"{i}|{name}|q"] = to_numpy(leaf["q"])
                arrays[f"{i}|{name}|s"] = to_numpy(leaf["scale"])
            else:
                arrays[f"{i}|{name}|f"] = to_numpy(leaf)
    buf = io.BytesIO()
    np.savez(buf, n_layers=np.asarray(len(qparams), np.int64),
             report=np.frombuffer(json.dumps(report or {}).encode(),
                                  np.uint8),
             **arrays)
    return buf.getvalue()


def unpack_quantized(blob: bytes, device=None):
    """The inverse of `pack_quantized`: (quantized params on `device`, the
    calibration report). Reads the JAX package's blobs too."""
    from deeplearning4j_tpu_torch.parallel.checkpoint import to_tensor

    with np.load(io.BytesIO(blob)) as z:
        n = int(z["n_layers"])
        report = json.loads(bytes(z["report"].tobytes()).decode() or "{}")
        layers = [dict() for _ in range(n)]
        for key in z.files:
            if "|" not in key:
                continue
            i, name, kind = key.split("|")
            d = layers[int(i)]
            t = to_tensor(z[key], device)
            if kind == "f":
                d[name] = t
            else:
                d.setdefault(name, {})["q" if kind == "q" else "scale"] = t
    return tuple(layers), report


# -- calibration data and the eval harness ----------------------------------

def default_calibration(conf, rows: int = 32, seed: int = 0) -> np.ndarray:
    """The JAX package's deterministic held-out batch for the conf's first
    layer (numpy `RandomState(seed)`): int32 ids [rows, min(max_seq_len or
    16, 32)] for an embedding, float32 [rows, 8, n_in] for a recurrent
    layer, else float32 [rows, n_in] (a leading `ff_to_conv` preprocessor
    names the flat width)."""
    from deeplearning4j_tpu_torch.nn.conf import LayerType

    rng = np.random.RandomState(seed)
    c0 = conf.conf(0)
    lt = LayerType(str(c0.layer_type))
    if lt == LayerType.EMBEDDING:
        seq = min(int(getattr(c0, "max_seq_len", 0) or 16), 32)
        return rng.randint(0, c0.n_in, size=(rows, seq)).astype(np.int32)
    if lt in (LayerType.LSTM, LayerType.GRAVES_LSTM):
        return rng.rand(rows, 8, c0.n_in).astype(np.float32)
    n_in = int(c0.n_in)
    pre = dict(conf.input_preprocessors or ())
    spec = str(pre.get(0, ""))
    if spec.startswith("ff_to_conv"):
        dims = [int(d) for d in spec.split(":")[1:]]
        n_in = int(np.prod(dims)) if dims else n_in
    return rng.rand(rows, n_in).astype(np.float32)


def accuracy_delta(conf, params, x, policy: str, qparams=None) -> dict:
    """A policy's outputs against the f32 forward on batch `x`: top-1
    agreement (classifiers) and the (relative) MSE; a softmax head budgets
    `top1_delta`, a reconstruction head `rel_mse`."""
    validate_policy(policy)
    ref = _host(policy_output(conf, params, x, "f32"))
    if policy == "f32":
        out = ref
    elif policy == "bf16":
        out = _host(policy_output(conf, cast_params_bf16(params), x, "bf16"))
    else:
        if qparams is None:
            qparams, _ = calibrate_int8(conf, params, x)
        out = _host(policy_output(conf, qparams, x, "int8"))
    mse = float(np.mean((out - ref) ** 2))
    denom = float(np.mean(ref ** 2)) or 1.0
    agree = float(np.mean(out.argmax(-1) == ref.argmax(-1)))
    return {"policy": policy, "rows": int(x.shape[0]),
            "top1_agreement": agree, "top1_delta": round(1.0 - agree, 6),
            "mse": mse, "rel_mse": mse / denom,
            "max_abs_err": float(np.max(np.abs(out - ref)))}


def error_budget_report(small: bool = True, seed: int = 0,
                        policies: Tuple[str, ...] = ("bf16", "int8"),
                        device=None) -> dict:
    """Every model of `zoo.precision_eval_confs` under every policy against
    `zoo.PRECISION_ERROR_BUDGETS`, as the JAX package measures it:
    seeded params, a 64-row (256 at full size) eval batch of seed + 1, an
    int8 calibration batch of 32 rows of seed + 2, eager forwards only.
    `device` None is the card."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    report = {}
    for name, conf in zoo.precision_eval_confs(small=small).items():
        net = MultiLayerNetwork(conf, device=device, seed=seed).init()
        x_eval = net._input(default_calibration(conf, rows=64 if small
                                                else 256, seed=seed + 1))
        budgets = zoo.PRECISION_ERROR_BUDGETS.get(name, {})
        entry = {}
        for policy in policies:
            qparams = None
            if policy == "int8":
                qparams, _ = calibrate_int8(
                    conf, net.params,
                    net._input(default_calibration(conf, rows=32,
                                                   seed=seed + 2)))
            delta = accuracy_delta(conf, net.params, x_eval, policy,
                                   qparams=qparams)
            budget = dict(budgets.get(policy, {}))
            delta["budget"] = budget
            delta["within_budget"] = all(delta[k] <= v
                                         for k, v in budget.items())
            entry[policy] = delta
        report[name] = entry
    return report


def assert_error_budgets(report: Optional[dict] = None) -> dict:
    """Raise if a model/policy pair exceeds its budget."""
    if report is None:
        report = error_budget_report()
    bad = []
    for model, entry in report.items():
        for policy, delta in entry.items():
            if not delta["within_budget"]:
                bad.append(f"{model}/{policy}: budget {delta['budget']} "
                           f"vs top1_delta={delta['top1_delta']:.4f} "
                           f"rel_mse={delta['rel_mse']:.3e}")
    if bad:
        raise AssertionError("precision error budget exceeded:\n"
                             + "\n".join(bad))
    return report
