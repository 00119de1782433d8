#!/usr/bin/env python3
"""The f32 flash-attention kernels of one checkout, timed on the card, for
comparing checkouts in one run.

    python3 ab_attention_f32.py [--root DIR] [--kernels-only]

Imports `deeplearning4j_tpu_torch` from DIR (default: this script's own
checkout), builds its flash forward and backward and prints one JSON line:
the forward kernel's device time by CUDA-graph replay at [8, 512, 16, 128]
f32 with lse, causal and not (contiguous) and causal on the qkv views of
one fused projection, and at the CLI char_transformer's [32, 256, 4, 32]
(causal, no lse); the f32 dK/dV and dQ kernels' at [8, 512, 16, 128]
causal and not (contiguous), causal on qkv views and causal at a ragged
[8, 200, 16, 100], with the forward kernel's o and lse and the plain delta
as inputs; each beside its error against the plain version; and, unless
`--kernels-only`, the f32 network output of the full-width charTransformer
(`chip_smoke.SLICE`, flash attention) on 2 x 512 tokens, eager, CUDA
events, median of 5. To compare two checkouts, run it on each in turns on
one card (parent, change, change, parent). Needs a CUDA device; exits 2
without one.
"""

from __future__ import annotations

import os
import sys

import numpy as np

import chip_smoke as smoke

CASES = [(8, 512, 16, 128, True, True, False),
         (8, 512, 16, 128, False, True, False),
         (8, 512, 16, 128, True, True, True),
         (32, 256, 4, 32, True, False, True)]
#: the f32 dK/dV and dQ cases: (B, S, H, D, causal, qkv views)
BWD_CASES = [(8, 512, 16, 128, True, False),
             (8, 512, 16, 128, False, False),
             (8, 512, 16, 128, True, True),
             (8, 200, 16, 100, True, False)]


def main(argv) -> int:
    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    if "--root" in argv:
        root = os.path.abspath(argv[argv.index("--root") + 1])
    if not torch.cuda.is_available():
        print("ab_attention_f32: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from deeplearning4j_tpu_torch.models.zoo import char_transformer
    from deeplearning4j_tpu_torch.nd import kernels
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        network_output)

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build(["flash_attn_fwd", "flash_attn_bwd"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, s, h, d, causal, with_lse, view in CASES:
        q, k, v = smoke.fwd_inputs(torch, gen, b, s, h, d, torch.float32,
                                   view)
        err_o, err_lse, ok = smoke.f32_fwd_check(torch, kernels, q, k, v,
                                                 causal, with_lse)
        rows.append({"shape": [b, s, h, d], "causal": causal,
                     "with_lse": with_lse, "view": view, "ok": ok,
                     "max_abs_err": err_o, "max_abs_err_lse": err_lse,
                     "kernel_ms": smoke.graph_ms(
                         lambda: kernels.flash_attention(
                             q, k, v, causal, with_lse=with_lse))})

    dkv_rows, dq_rows = [], []
    for b, s, h, d, causal, view in BWD_CASES:
        _, q, k, v, do, o, lse = smoke.bwd_inputs(
            torch, kernels, gen, b, s, h, d, torch.float32, causal, view)
        delta = kernels.flash_bwd_delta_reference(o, do)
        args = (q, k, v, do, lse, delta, causal)
        got = kernels.flash_bwd_dkv(*args)
        want = kernels.flash_bwd_dkv_reference(*args)
        (err_k, ok_k), (err_v, ok_v) = (smoke.bwd_close(torch, g, w)
                                        for g, w in zip(got, want))
        case = {"shape": [b, s, h, d], "causal": causal, "view": view}
        dkv_rows.append(dict(case, ok=ok_k and ok_v,
                             max_abs_err=max(err_k, err_v),
                             kernel_ms=smoke.graph_ms(
                                 lambda: kernels.flash_bwd_dkv(*args))))
        err_q, ok_q = smoke.bwd_close(torch, kernels.flash_bwd_dq(*args),
                                      kernels.flash_bwd_dq_reference(*args))
        dq_rows.append(dict(case, ok=ok_q, max_abs_err=err_q,
                            kernel_ms=smoke.graph_ms(
                                lambda: kernels.flash_bwd_dq(*args))))
        del q, k, v, do, o, lse, delta, args, got, want
    result = {"root": root, "gpu": smoke.gpu_line(), "cases": rows,
              "dkv_cases": dkv_rows, "dq_cases": dq_rows}
    ok = all(r["ok"] for r in rows + dkv_rows + dq_rows)
    if "--kernels-only" in argv:
        smoke.emit(result)
        return 0 if ok else 1

    conf = char_transformer(smoke.SLICE["vocab"],
                            d_model=smoke.SLICE["d_model"],
                            n_blocks=smoke.SLICE["n_blocks"],
                            n_heads=smoke.SLICE["n_heads"],
                            max_seq_len=smoke.SLICE["seq"])
    conf = conf.with_compute_dtype("")
    conf = conf.replace(confs=tuple(c.replace(attention_impl="flash")
                                    for c in conf.confs))
    net = MultiLayerNetwork(conf, device="cuda", seed=0).init()
    x = torch.as_tensor(np.random.RandomState(0).randint(
        0, smoke.SLICE["vocab"], (smoke.REQUEST_ROWS, smoke.SLICE["seq"])),
        device="cuda")
    with torch.inference_mode():
        network_output(conf, net.params, x)
        times = [smoke.event_ms(torch, lambda: network_output(
            conf, net.params, x)) for _ in range(5)]
    smoke.emit(dict(result, f32_forward_ms=sorted(times)[2],
                    f32_forward_ms_all=times))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
