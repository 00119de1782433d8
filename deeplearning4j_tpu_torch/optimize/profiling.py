"""Per-op cost accounting of a train step: the analytic model and a counted
total.

The port's counterpart of `deeplearning4j_tpu/optimize/profiling.py`. It
splits a transformer train step's cost into the op categories the hot-path
work targets --

  matmul         weight GEMMs (qkv / proj / ffn / logits), fwd + bwd
  attention_fwd  the S x S score + value products per head, forward
  attention_bwd  the grad products (dQ/dK/dV)
  elementwise    layernorm / gelu / softmax / residual traffic
  updater        the optimizer chain over every parameter
  transfer       host -> device batch bytes per step

-- from two sources that cross-check each other:

  1. analytic counts from the model dimensions alone
     (`transformer_step_costs`, `attention_block_bytes`, `breakdown`,
     `OpCost`, `CATEGORIES`, `ATTENTION_BWD_MODES`: the JAX package's,
     exactly);
  2. a counted total of one uncaptured call of the step (`compiled_totals`).
     The JAX package reads XLA's cost analysis of the compiled executable;
     a captured CUDA graph has none, so the port counts flops with
     `torch.utils.flop_counter.FlopCounterMode` over one eager call, and
     adds the flash kernels' flops by their formula (`FLASH_FLOPS`: a
     custom `autograd.Function` that launches a CUDA kernel is invisible to
     the counter, and on the CPU the plain version's products are taken
     back and replaced by the same formula, so that both devices count
     alike). Its `bytes` is 0.0: the counter counts no traffic (ROADMAP.md
     queue C).

`breakdown` reconciles the two: per-category flops/bytes plus the
`unattributed` remainder of the measured total the analytic model does
not cover.

`chrome_trace` wraps `torch.profiler` around a body and writes a Chrome
trace; `maybe_trace` does so on CUDA only, and is a no-op on the CPU.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, NamedTuple

CATEGORIES = ("matmul", "attention_fwd", "attention_bwd", "elementwise",
              "updater", "transfer")

#: analytic attention-backward flop multiples of the forward's 4*S*d per
#: token per block, by backward implementation (see
#: `transformer_step_costs`)
ATTENTION_BWD_MODES = ("dense", "fused", "recompute")


class OpCost(NamedTuple):
    flops: float
    bytes: float


def attention_block_bytes(seq: int, head_dim: int, block_q: int,
                          block_k: int, dtype_bytes: int = 4) -> float:
    """HBM traffic of one flash-attention head at (block_q, block_k):
    each of the S/bq Q tiles streams the full K and V ([S, D] each), Q
    itself and the output are read/written once, and every (q, k) tile
    pair touches a [bq, bk] f32 scores tile in VMEM.  This is the
    autotuner's pruning signal (`optimize/tunables.py` cost hints):
    relative cost across candidate blocks, not an absolute roofline —
    halving block_q doubles the K/V streaming term, which is exactly the
    2x the pruner cuts on."""
    q_tiles = max(1, -(-seq // block_q))
    stream = q_tiles * 2 * seq * head_dim           # K + V per Q tile
    once = 2 * seq * head_dim                       # Q in, O out
    scores = q_tiles * max(1, -(-seq // block_k)) * block_q * block_k
    return float(dtype_bytes) * (stream + once + scores)


def transformer_step_costs(*, batch: int, seq: int, d_model: int,
                           n_blocks: int, vocab: int, n_params: int,
                           dtype_bytes: int = 2,
                           sparse_labels: bool = False,
                           attention_bwd_mode: str = "dense") -> dict:
    """Analytic per-category costs for ONE char-transformer train step.

    Exact pieces (standard dense-transformer accounting):
      matmul GEMM params  P_mm = 12*d^2 per block (qkv 3d^2 + proj d^2 +
      ffn up/down 8d^2) + d*vocab logits; fwd+bwd = 6 * P_mm * tokens.
      attention_fwd = 4 * u where u = n_blocks * tokens * seq * d_model
      (scores 2*S*d + values 2*S*d per token per block).
      attention_bwd depends on the backward implementation
      (`attention_bwd_mode`):
        "dense"     8 * u — XLA autodiff of full/blockwise attention: the
                    four grad products (dV, dP, dS->dK, dS->dQ) with the
                    probabilities retained from the forward;
        "fused"     10 * u — the fused Pallas backward
                    (`attention_fused_bwd`): same four grad products plus
                    one in-kernel score recompute (2*u), which is the
                    price of never materializing [S,S];
        "recompute" 12 * u — the jax-level fallback VJP: the 8*u autodiff
                    products plus a full forward re-run (4*u).  This is
                    the term the fused path eliminates; pre-split
                    accounting lumped attention at 12*u total and silently
                    undercounted this path, inflating `unattributed`.

    Coarse pieces (coefficients below, documented not derived):
      elementwise: ~60 flops per activation element per block fwd+bwd
      (2 layernorms ~20, gelu ~16, softmax ~8, residuals/bias ~4, x2 bwd).
      updater: ~12 flops/param (chain: decay, moment updates, scale,
      clip norms), f32 traffic = 4 reads (param, grad, 2 state) +
      3 writes (param, 2 state).

    transfer counts the per-step host->device batch bytes: int32 ids for
    x, and labels either int32 ids (sparse) or a one-hot [tokens, vocab]
    row matrix — the whole point of `sparse_labels` is this vocab-fold
    reduction plus the gathered (never materialized) one-hot in the loss.
    """
    if attention_bwd_mode not in ATTENTION_BWD_MODES:
        raise ValueError(f"attention_bwd_mode={attention_bwd_mode!r} not in "
                         f"{ATTENTION_BWD_MODES}")
    tokens = batch * seq
    p_mm = 12 * n_blocks * d_model * d_model + d_model * vocab
    matmul = OpCost(6.0 * p_mm * tokens,
                    3.0 * p_mm * dtype_bytes)  # weights read fwd+bwd+gradw
    attn_unit = float(n_blocks * tokens * seq * d_model)
    # q/k/v/scores read+write per block: 1x the per-block traffic fwd,
    # 2x bwd (grads flow back through both products)
    attn_traffic = (3 * tokens * d_model + batch * seq * seq) * dtype_bytes
    bwd_mult = {"dense": 8.0, "fused": 10.0, "recompute": 12.0}
    attention_fwd = OpCost(4.0 * attn_unit, 1.0 * n_blocks * attn_traffic)
    attention_bwd = OpCost(bwd_mult[attention_bwd_mode] * attn_unit,
                           2.0 * n_blocks * attn_traffic)
    elementwise = OpCost(60.0 * n_blocks * tokens * d_model,
                         6.0 * n_blocks * tokens * d_model * dtype_bytes)
    updater = OpCost(12.0 * n_params, 7.0 * n_params * 4)
    label_bytes = tokens * (4 if sparse_labels else vocab * dtype_bytes)
    transfer = OpCost(0.0, tokens // max(seq, 1) * seq * 4 + label_bytes)
    return {"matmul": matmul, "attention_fwd": attention_fwd,
            "attention_bwd": attention_bwd,
            "elementwise": elementwise, "updater": updater,
            "transfer": transfer}


#: flops of the flash kernels by their formula, in units of B*H*S*S*D: the
#: forward's two products (scores, values); the dK/dV kernel's recomputed
#: scores and dP and its dV and dK products; the dQ kernel's recomputed
#: scores and dP and its dQ product. The delta kernel's 2*B*S*H*D is
#: counted apart. Causal masking halves the work a kernel does, not what is
#: counted here, as the analytic model counts whole products.
FLASH_FLOPS = {"flash_attn_fwd": 4.0, "flash_bwd_dkv": 8.0,
               "flash_bwd_dq": 6.0}


def compiled_totals(step: Callable, *args, **kwargs) -> dict | None:
    """Flops of one uncaptured call `step(*args, **kwargs)`: what
    `FlopCounterMode` counts, plus the flash kernels' flops by formula
    (`FLASH_FLOPS`). Returns {"flops", "bytes" (0.0: not counted),
    "attention_flops" (the flash kernels' part), "matmul_flops" (the rest
    of the counted products)}, or None when nothing was counted or the call
    failed (never raises: the caller still reports its breakdown)."""
    from torch.utils.flop_counter import FlopCounterMode

    from deeplearning4j_tpu_torch.nd import kernels

    attention = [0.0]
    inner = [0.0]
    names = tuple(FLASH_FLOPS) + ("flash_bwd_delta",)
    saved = {name: getattr(kernels, name) for name in names}

    def counted(name):
        fn = saved[name]

        def wrapper(*a, **kw):
            q = a[0]
            b, s, h, d = q.shape
            unit = float(b) * h * s * d
            attention[0] += (unit * 2.0 if name == "flash_bwd_delta"
                             else FLASH_FLOPS[name] * unit * s)
            before = mode.get_total_flops()
            out = fn(*a, **kw)
            inner[0] += mode.get_total_flops() - before
            return out
        return wrapper

    try:
        mode = FlopCounterMode(display=False)
        for name in names:
            setattr(kernels, name, counted(name))
        try:
            with mode:
                step(*args, **kwargs)
        finally:
            for name, fn in saved.items():
                setattr(kernels, name, fn)
        matmul = float(mode.get_total_flops()) - inner[0]
        flops = matmul + attention[0]
        if flops <= 0.0:
            return None
        return {"flops": flops, "bytes": 0.0, "attention_flops": attention[0],
                "matmul_flops": matmul}
    except Exception:  # noqa: BLE001 - a breakdown ships without totals
        return None


def breakdown(analytic: dict, totals: dict | None = None,
              step_seconds: float | None = None) -> dict:
    """Reconcile analytic per-category costs against measured totals.

    Returns a JSON-ready dict: per category {flops, bytes, flop_fraction}
    (fractions of the MEASURED total when available, else of the analytic
    sum), the measured totals, and the `unattributed` remainder — measured
    minus modelled, floored at 0.  With `step_seconds`, each category also
    gets its implied TFLOP/s so the hot spot reads directly off the JSON.
    """
    modelled_flops = sum(c.flops for c in analytic.values())
    total_flops = (totals or {}).get("flops") or modelled_flops
    out = {"categories": {}, "modelled_flops": modelled_flops}
    for name in CATEGORIES:
        c = analytic.get(name)
        if c is None:
            continue
        entry = {"flops": c.flops, "bytes": c.bytes,
                 "flop_fraction": round(c.flops / total_flops, 4)
                 if total_flops else 0.0}
        if step_seconds:
            entry["tflops_per_sec"] = round(c.flops / step_seconds / 1e12, 3)
        out["categories"][name] = entry
    if totals:
        out["measured_flops"] = totals["flops"]
        out["measured_bytes"] = totals["bytes"]
        out["unattributed_flops"] = max(0.0,
                                        totals["flops"] - modelled_flops)
        out["unattributed_fraction"] = round(
            out["unattributed_flops"] / totals["flops"], 4) \
            if totals["flops"] else 0.0
    return out


@contextlib.contextmanager
def chrome_trace(trace_dir: str, cuda: bool):
    """`torch.profiler` around the body (CPU activity, and CUDA activity
    when `cuda`), the Chrome trace written to `trace_dir/trace.json` at the
    end. Yields the path. The one tracer of the port: `maybe_trace` and
    `utils/profiling.Tracer` both go through it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if cuda:
            # the body's kernels end inside the profile, so that their
            # device records are in the trace
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None = None):
    """`chrome_trace` around the body when a dir is given AND a CUDA card
    is there (CPU and CUDA activities, a Chrome trace written into
    `trace_dir`); a no-op otherwise."""
    from deeplearning4j_tpu_torch.nd.platform import cuda_available

    if not trace_dir or not cuda_available():
        yield
        return
    with chrome_trace(trace_dir, cuda=True):
        yield
