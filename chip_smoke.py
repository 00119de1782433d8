#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU. It
imports `deeplearning4j_tpu_torch` (never JAX or `deeplearning4j_tpu`) and:

1. prints the card (`nvidia-smi` name and power limit) and the versions;
2. builds every kernel of the serving and training paths from
   `deeplearning4j_tpu_torch/csrc/` with nvcc (sm_90a), one nvcc per source,
   all started together;
3. holds the flash-attention forward kernel against its plain PyTorch
   version on the card, at the serving shape (contiguous inputs, and the
   strided views of one fused qkv projection that the serving path passes),
   at the train step's shape with lse on those views, and at a ragged
   shape, and times the kernel, the plain version and the
   one PyTorch call that computes the same function by CUDA-graph replay
   (device time, no host launch cost), the wrapper's eager call
   (`call_ms`), and the bound (the least time the card could take);
4. does the same for the three kernels of the fused attention backward
   (delta, dK/dV, dQ): bf16 causal at the training shape on qkv views, f32
   causal and not, and a ragged S; checks `FlashAttentionFunction`'s
   gradients against autograd through the plain forward, both taken with
   respect to the fused qkv projection whose views they read; the yardstick is
   the backward of `scaled_dot_product_attention` (its forward plus
   backward, less its forward);
5. serves the full-width charTransformer (vocab 256, d_model 2048, 8 blocks,
   16 heads, seq 512, bf16 compute, random weights from a seed) through
   `MultiLayerNetwork.serve` to 4 concurrent POST /v1/predict requests,
   checks each answer against a direct `net.output`, checks the flash path
   against the plain attention path in f32, and checks that every forward
   pass launched the flash kernel once per attention layer;
6. trains the same network with `MultiLayerNetwork.fit` (the JAX package's
   flagship training conf, bench.py:558-567: Adam, sparse labels, fused
   updater, fused attention backward, bf16 compute over f32 weights) for
   TRAIN_STEPS one-step calls on one batch of 32 x 512 tokens, checks that
   the scores are finite and fall and that each step launched the forward
   kernel and each backward kernel once per attention layer, traces one
   more step with `torch.profiler` (device time by kernel, idle share), and
   checks the fused backward's gradients against the recompute path in f32;
7. holds the fused LSTM cell kernel against its plain version at the
   char-LSTM bench shape (f32; on the row-block views of one W; bf16), at
   the CLI's ragged shape and at a tiny ragged one, timed beside its plain
   version, `torch.lstm_cell` and its bound, and one [256, 64, 256] layer
   (64 launches) beside cuDNN's `nn.LSTM`;
8. trains the bench's 4-layer char-LSTM (bench.py:252-261: vocab 50, embed
   and hidden 256, seq 64, batch 256, bf16 output layer, SGD with momentum)
   for LSTM_STEPS one-step `fit` calls on the word corpus of bench.py:1706,
   checks that the scores fall and that every forward launched the cell
   kernel 4 * 64 times, profiles one more step, and holds the kernel path
   to the hoisted scan in f32 (outputs, gradients) and times both;
9. runs the CLI north star in process (bench.py:1716-1719: `train --zoo
   char_lstm:layers=4,hidden=128` over the corpus as text windows of 32),
   then `predict` and `test` on its checkpoint;
10. holds the embedding-row scatter-add kernel against its plain version at
   the word2vec step's shapes (syn1 from the bench vocabulary's Huffman
   points, syn0, syn1neg), a GloVe bias (D = 1), a tiny ragged case with
   out-of-range indices and bf16: exact on integer-valued inputs, within
   the any-order summation bound on random ones, timed beside its plain
   version, `index_add_` and its bound;
11. trains the bench's Word2Vec at full size (bench.py:368-385: vocab
   10,000, 1.2M zipf tokens, vector 128, window 5, negative 5, HS, batch
   32,768, 6 epochs) through `Word2Vec.fit`: words/s as bench.py:391
   computes it, step time, 3 scatter launches a step and profiled steps;
   then one epoch of the same with per-word AdaGrad, whose tables stay
   finite and whose loss on a fixed batch falls (the bench's SGD diverges,
   in the JAX package too);
12. trains Word2Vec, ParagraphVectors and GloVe on the two-cluster corpus of
   tests/test_embeddings.py and passes its similarity assertions, each
   launching the scatter kernel once per gather of every step.

Each phase prints one JSON line; then a line with every kernel's numbers,
the card's line, and last `{"ok": true, "device": {...}}`. Any failure exits
non-zero before the last line. Without a CUDA device it exits 2 at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet, dense): FLOP/s by operand type, HBM B/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

SLICE = dict(vocab=256, d_model=2048, n_blocks=8, n_heads=16, seq=512)
REQUESTS, REQUEST_ROWS = 4, 2
TRAIN_ROWS, TRAIN_STEPS = 32, 5
# The zoo's lr is 1e-3. `fit` restarts Adam from zero moments on every call,
# as the JAX package does, so each one-iteration call moves every weight by
# about lr (Adam's first step is lr * g / (|g| + eps)). At d_model 2048 on
# this batch the score rises with TRAIN_LR at 1e-4 and 1e-3 and falls at
# 1e-5 (on an H100; PERF.md). The JAX package's `fit` rises alike at the
# zoo's lr (tests/test_torch_training.py, at d_model 512 and 8 blocks).
TRAIN_LR = 1e-5


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Device time of one fn() call: `iters` calls captured into one CUDA
    graph, the graph replayed `replays` times between CUDA events. Replay
    launches the kernels back to back with no host work between them, so
    this is the kernels' own time, without the Python and launch cost that
    `cuda_ms` includes."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (iters * replays)
    del graph
    return ms


def attention_bound_ms(b, s, h, d, dtype_name, causal, with_lse):
    """max(operations / peak rate, bytes / HBM rate) for one forward: the
    scores and P.V products (halved when causal), q, k, v read once, o (and
    lse) written once."""
    size = 2 if dtype_name == "bfloat16" else 4
    flops = 4.0 * b * h * s * s * d * (0.5 if causal else 1.0)
    nbytes = 4.0 * b * s * h * d * size + (4.0 * b * h * s if with_lse else 0)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def bwd_bound_ms(name, b, s, h, d, dtype_name, causal):
    """max(operations / peak rate, bytes / HBM rate) for one backward
    kernel: each input read once, each output written once. dK/dV: four
    products of [S, S, D] per head (QK^T, dO V^T, P^T dO, dS^T Q); dQ: three
    (QK^T, dO V^T, dS K); both halved when causal. Delta: o and dO read,
    one f32 per row written."""
    size = 2 if dtype_name == "bfloat16" else 4
    elems = float(b * s * h * d)
    rows = 4.0 * b * h * s                     # one f32 per (b, h, row)
    half = 0.5 if causal else 1.0
    if name == "flash_bwd_delta":
        flops, nbytes = 2.0 * elems, 2 * elems * size + rows
    elif name == "flash_bwd_dkv":
        flops = 8.0 * b * h * s * s * d * half
        nbytes = 6 * elems * size + 2 * rows
    else:
        flops = 6.0 * b * h * s * s * d * half
        nbytes = 5 * elems * size + 2 * rows
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def qkv_views(qkv, h, d):
    """q, k, v as nn/layers/attention.py builds them from one fused
    [B, S, 3 * H * D] projection: views with sequence stride 3 * H * D."""
    b, s = qkv.shape[:2]
    q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    check(q.stride(1) == 3 * h * d, f"q strides {q.stride()}")
    return q, k, v


def bwd_inputs(torch, kernels, gen, b, s, h, d, dt, causal, view):
    """The fused qkv projection (None unless `view`), q, k, v (its strided
    views when `view`, as the attention layer passes them), dO, and the
    forward kernel's o and lse on them."""
    qkv = None
    if view:
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dt)
        q, k, v = qkv_views(qkv, h, d)
    else:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                   .to(dt) for _ in range(3))
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
    o, lse = kernels.flash_attn_fwd(q, k, v, causal, with_lse=True)
    return qkv, q, k, v, do, o, lse


def bwd_close(torch, got, want):
    """(max |got - want|, ok) at the stated tolerance: f32 outputs atol =
    rtol = 1e-4; bf16 outputs max |got - want| <= 2e-2 * max |want| (both
    are rounded to bf16 once, from f32 sums taken in different orders)."""
    err = (got.float() - want.float()).abs().max().item()
    if want.dtype == torch.float32:
        ok = bool(torch.allclose(got, want, atol=1e-4, rtol=1e-4))
    else:
        ok = err <= 2e-2 * want.float().abs().max().item()
    return err, ok


def bwd_check(torch, kernels, q, k, v, do, o, lse, causal):
    """Each backward kernel against its plain version on the same inputs
    (dK/dV and dQ both take the plain delta); returns {kernel:
    (max_abs_err, ok)}."""
    out = {}
    delta = kernels.flash_bwd_delta_reference(o, do)
    out["flash_bwd_delta"] = bwd_close(torch,
                                       kernels.flash_bwd_delta(o, do), delta)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    wk, wv = kernels.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    ek, okk = bwd_close(torch, dk, wk)
    ev, okv = bwd_close(torch, dv, wv)
    out["flash_bwd_dkv"] = (max(ek, ev), okk and okv)
    out["flash_bwd_dq"] = bwd_close(
        torch, kernels.flash_bwd_dq(q, k, v, do, lse, delta, causal),
        kernels.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal))
    torch.cuda.synchronize()
    return out


def grad_function_check(torch, kernels, qkv, h, d, do, causal):
    """`FlashAttentionFunction` (forward kernel with lse, then delta, dK/dV
    and dQ) against autograd through `flash_attention_reference`, both on
    q, k, v views of one fused projection as the train step passes them,
    with gradients taken with respect to the projection; (max_abs_err over
    its dq, dk and dv parts, ok) at the bf16 tolerance, per part."""
    def grad(fn):
        leaf = qkv.detach().clone().requires_grad_()
        (g,) = torch.autograd.grad(fn(*qkv_views(leaf, h, d), causal), leaf,
                                   do)
        return g.split(h * d, dim=-1)

    got = grad(lambda q, k, v, c: kernels.flash_attention(q, k, v, c,
                                                          fused_bwd=True))
    want = grad(kernels.flash_attention_reference)
    torch.cuda.synchronize()
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    ok = all(e <= 2e-2 * w.float().abs().max().item()
             for e, w in zip(errs, want))
    return max(errs), ok


def sdpa_backward_ms(torch, q, k, v, do, causal):
    """The library yardstick for the whole fused backward: one
    `scaled_dot_product_attention` forward plus its backward, less the
    forward alone, each by CUDA-graph replay, at the same inputs."""
    import torch.nn.functional as F

    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    gt = do.transpose(1, 2)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        return torch.autograd.grad(out, (qt, kt, vt), gt)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)

    return graph_ms(fwd_bwd) - graph_ms(fwd)


BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dq")


def phase_bwd_kernels(torch, kernels):
    """The three backward kernels against their plain versions on the card,
    at the train path's shape and layout (bf16, causal, q/k/v views of one
    fused qkv projection, B=32 S=512 H=16 D=128), in f32 causal and not,
    and at a ragged S; timed at every case. Returns {kernel: row} of the
    train-path case."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(32, 512, 16, 128, torch.bfloat16, True, True),
             (8, 512, 16, 128, torch.float32, True, False),
             (8, 512, 16, 128, torch.float32, False, False),
             (8, 200, 16, 64, torch.bfloat16, True, False)]
    main_rows = {}
    for b, s, h, d, dt, causal, view in cases:
        qkv, q, k, v, do, o, lse = bwd_inputs(torch, kernels, gen, b, s, h,
                                              d, dt, causal, view)
        results = bwd_check(torch, kernels, q, k, v, do, o, lse, causal)
        dname = str(dt).replace("torch.", "")
        grad_err = grad_ok = None
        if view:
            grad_err, grad_ok = grad_function_check(torch, kernels, qkv, h, d,
                                                    do, causal)
        library_ms = sdpa_backward_ms(torch, q, k, v, do, causal)
        delta = kernels.flash_bwd_delta(o, do)
        calls = {
            "flash_bwd_delta": (lambda: kernels.flash_bwd_delta(o, do),
                                lambda: kernels.flash_bwd_delta_reference(
                                    o, do)),
            "flash_bwd_dkv": (lambda: kernels.flash_bwd_dkv(
                q, k, v, do, lse, delta, causal),
                lambda: kernels.flash_bwd_dkv_reference(
                    q, k, v, do, lse, delta, causal)),
            "flash_bwd_dq": (lambda: kernels.flash_bwd_dq(
                q, k, v, do, lse, delta, causal),
                lambda: kernels.flash_bwd_dq_reference(
                    q, k, v, do, lse, delta, causal)),
        }
        for name in BWD_KERNELS:
            err, ok = results[name]
            kernel_fn, plain_fn = calls[name]
            bound_ms, bound_by = bwd_bound_ms(name, b, s, h, d, dname,
                                              causal)
            row = {"phase": "bwd_kernel", "name": name, "shape": [b, s, h, d],
                   "dtype": dname, "causal": causal, "view": view,
                   "max_abs_err": err, "ok": ok,
                   "kernel_ms": graph_ms(kernel_fn),
                   "call_ms": cuda_ms(kernel_fn),
                   "plain_ms": graph_ms(plain_fn, iters=3, replays=1),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "sdpa_backward_ms": library_ms}
            if view:
                row["grad_fn_max_abs_err"] = grad_err
                row["grad_fn_ok"] = grad_ok
            emit(row)
            check(ok, f"{name} disagrees with its plain version: {row}")
            if view:
                check(grad_ok, f"FlashAttentionFunction grads disagree with "
                               f"autograd of the plain forward: {row}")
                main_rows[name] = row
        del qkv, q, k, v, do, o, lse, delta, calls
        torch.cuda.empty_cache()
    return main_rows


def phase_kernels(torch, kernels):
    """Kernel vs plain version on the card; returns the rows of the two
    cases the main paths run, both bf16 and causal on q, k, v strided views
    of one fused [B, S, 3 * H * D] projection: serving (B=8, no lse) and
    the train step's forward (B=32, with lse)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for with_lse in (False, True):
                cases.append((8, 512, 16, 128, dt, causal, with_lse, False))
    cases += [(8, 512, 16, 128, torch.bfloat16, True, False, True),
              (32, 512, 16, 128, torch.bfloat16, True, True, True),
              (8, 200, 16, 64, torch.bfloat16, True, True, False),
              (8, 200, 16, 64, torch.float32, False, True, False)]
    path_rows = {}
    for b, s, h, d, dt, causal, with_lse, view in cases:
        if view:
            qkv = torch.randn(b, s, 3 * h * d, generator=gen,
                              device="cuda").to(dt)
            q, k, v = qkv_views(qkv, h, d)
        else:
            q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                       .to(dt) for _ in range(3))
        got = kernels.flash_attention(q, k, v, causal, with_lse=with_lse)
        want = kernels.flash_attention_reference(q, k, v, causal,
                                                 with_lse=with_lse)
        torch.cuda.synchronize()
        if not with_lse:
            got, want = (got, None), (want, None)
        err_o = (got[0].float() - want[0].float()).abs().max().item()
        if dt == torch.float32:
            ok = torch.allclose(got[0], want[0], atol=1e-4, rtol=1e-4)
        else:
            ok = torch.allclose(got[0].float(), want[0].float(), atol=2e-2)
        err_lse = None
        if with_lse:
            err_lse = (got[1] - want[1]).abs().max().item()
            tol = 1e-4 if dt == torch.float32 else 1e-3
            ok = ok and torch.allclose(got[1], want[1], atol=tol, rtol=tol)
        dname = str(dt).replace("torch.", "")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kernel_ms = graph_ms(lambda: kernels.flash_attention(
            q, k, v, causal, with_lse=with_lse))
        call_ms = cuda_ms(lambda: kernels.flash_attention(
            q, k, v, causal, with_lse=with_lse))
        plain_ms = graph_ms(lambda: kernels.flash_attention_reference(
            q, k, v, causal, with_lse=with_lse), iters=5, replays=1)
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        bound_ms, bound_by = attention_bound_ms(b, s, h, d, dname, causal,
                                                with_lse)
        row = {"phase": "kernel", "name": "flash_attn_fwd",
               "shape": [b, s, h, d], "dtype": dname, "causal": causal,
               "with_lse": with_lse, "view": view, "max_abs_err": err_o,
               "max_abs_err_lse": err_lse, "ok": bool(ok),
               "kernel_ms": kernel_ms, "call_ms": call_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        check(ok, f"flash_attn_fwd disagrees with its plain version: {row}")
        if view:
            path_rows["train" if with_lse else "serve"] = row
        del q, k, v, qt, kt, vt, got, want
        torch.cuda.empty_cache()
    return path_rows["serve"], path_rows["train"]


def post(url, body, timeout=300.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def phase_serve(torch, kernels):
    """The full-width charTransformer served to concurrent requests."""
    from deeplearning4j_tpu_torch.models.zoo import char_transformer
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        network_output)

    conf = char_transformer(SLICE["vocab"], d_model=SLICE["d_model"],
                            n_blocks=SLICE["n_blocks"],
                            n_heads=SLICE["n_heads"],
                            max_seq_len=SLICE["seq"])
    conf = conf.with_compute_dtype("bfloat16")
    conf = conf.replace(confs=tuple(c.replace(attention_impl="flash")
                                    for c in conf.confs))
    t0 = time.perf_counter()
    net = MultiLayerNetwork(conf, device="cuda", seed=0).init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for layer in net.params for t in layer.values())
    rng = np.random.RandomState(0)
    xs = [rng.randint(0, SLICE["vocab"], (REQUEST_ROWS, SLICE["seq"]))
          for _ in range(REQUESTS)]
    net.output(xs[0])  # first-call set-up (cuBLAS handles) outside the run
    torch.cuda.synchronize()

    kernels.reset_launches()
    server = net.serve(port=0, max_delay_ms=200.0,
                       max_batch_rows=REQUESTS * REQUEST_ROWS)
    answers = [None] * REQUESTS
    latencies = [None] * REQUESTS
    errors = []

    def client(i):
        t = time.perf_counter()
        try:
            answers[i] = np.asarray(post(server.url + "/v1/predict",
                                         {"features": xs[i].tolist(),
                                          "dtype": "int32"})["output"],
                                    np.float32)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        latencies[i] = (time.perf_counter() - t) * 1e3

    t_all = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t_all
    stats = server.stats()
    serve_launches = dict(kernels.LAUNCHES)
    # an id outside the vocabulary is refused on the host with a 400; on
    # the card it would be a device-side assert that ends the process's
    # CUDA context (the direct checks below then show the card still works)
    bad = xs[0].copy()
    bad[0, 0] = 300
    try:
        post(server.url + "/v1/predict", {"features": bad.tolist(),
                                          "dtype": "int32"})
        bad_status = 200
    except urllib.error.HTTPError as e:
        bad_status = e.code
    server.drain()
    check(not errors, f"requests failed: {errors}")
    check(bad_status == 400, f"an out-of-vocabulary id got {bad_status}")
    flushes = sum(stats["batch_rows_hist"].values())
    n_attn = SLICE["n_blocks"]
    check(serve_launches["flash_attn_fwd"] == n_attn * flushes,
          f"flash launches {serve_launches} != {n_attn} x {flushes} flushes")

    errs_direct = []
    kernels.reset_launches()
    for x, ans in zip(xs, answers):
        check(ans.shape == (REQUEST_ROWS * SLICE["seq"], SLICE["vocab"]),
              f"answer shape {ans.shape}")
        check(bool(np.isfinite(ans).all()), "answer has non-finite values")
        row_err = float(np.abs(ans.sum(axis=1) - 1.0).max())
        check(row_err < 1e-3, f"rows do not sum to 1: {row_err}")
        direct = net.output(x).float().cpu().numpy()
        errs_direct.append(float(np.abs(ans - direct).max()))
    direct_launches = kernels.LAUNCHES["flash_attn_fwd"]
    check(direct_launches == n_attn * REQUESTS,
          f"direct checks launched flash {direct_launches} times, want "
          f"{n_attn * REQUESTS}")
    check(max(errs_direct) < 2e-2,
          f"served answer differs from net.output: {errs_direct}")

    # the flash path against the plain attention path on the same weights,
    # in f32 compute, where the two differ only by f32 rounding (in bf16
    # the plain path's bf16 softmax is the larger error)
    f32_conf = conf.with_compute_dtype("")
    plain_conf = f32_conf.replace(confs=tuple(
        c.replace(attention_impl="full") for c in f32_conf.confs))
    with torch.inference_mode():
        x0 = torch.as_tensor(xs[0], device="cuda")
        flash32 = network_output(f32_conf, net.params, x0)
        plain32 = network_output(plain_conf, net.params, x0)
    err_plain = (flash32 - plain32).abs().max().item()
    check(err_plain < 1e-4,
          f"f32 flash path differs from the plain attention path: "
          f"{err_plain}")
    # where a request's time goes: one eager forward over the coalesced
    # batch (CUDA events; host launch work included), and the host's JSON
    # work on one answer
    xb = np.concatenate(xs)
    forward_ms = cuda_ms(lambda: net.output(xb), iters=5, warmup=1)
    t = time.perf_counter()
    body = json.dumps({"output": answers[0].tolist()})
    encode_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    json.loads(body)
    decode_ms = (time.perf_counter() - t) * 1e3
    rows = REQUESTS * REQUEST_ROWS
    emit({"phase": "serve", "config": SLICE, "compute_dtype": "bfloat16",
          "params": n_params, "init_s": init_s,
          "requests": REQUESTS, "rows_per_request": REQUEST_ROWS,
          "latency_ms": latencies, "wall_s": wall_s,
          "server_latency_ms": stats["latency_ms"],
          "forward_ms": forward_ms,
          "answer_json_encode_ms": encode_ms,
          "answer_json_decode_ms": decode_ms,
          "answer_json_bytes": len(body),
          "rows_per_s": rows / wall_s,
          "tokens_per_s": rows * SLICE["seq"] / wall_s,
          "batch_rows_hist": stats["batch_rows_hist"],
          "flash_launches_serve": serve_launches["flash_attn_fwd"],
          "out_of_vocab_status": bad_status,
          "flash_launches_direct": direct_launches,
          "max_abs_err_vs_direct": max(errs_direct),
          "max_abs_err_f32_flash_vs_plain_attention": err_plain,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return serve_launches


def profile_step(torch, kernels, net, x, y, phase="train_profile",
                 ours_key="flash_") -> dict:
    """One more training step under `torch.profiler`: prints the device
    time by kernel name (the 15 largest), the device time of the port's
    kernels (names holding `ours_key`), the sum over every kernel, and the
    step's wall time, from which the device's idle share follows. Launches
    made here are not counted as the main path's. Returns the row."""
    from torch.profiler import ProfilerActivity, profile

    saved = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels.LAUNCHES.update(saved)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    events.sort(key=lambda e: -e.device_time_total)
    total_us = sum(e.device_time_total for e in events)
    ours = [e for e in events if ours_key in e.key]
    row = {"phase": phase, "wall_ms": wall_ms,
           "device_ms": total_us / 1e3,
           "idle_share": 1.0 - total_us / 1e3 / wall_ms,
           "port_kernels_ms": sum(e.device_time_total for e in ours) / 1e3,
           "kernel_count": sum(e.count for e in events),
           "top": [{"name": e.key[:90], "calls": e.count,
                    "ms": e.device_time_total / 1e3} for e in events[:15]]}
    emit(row)
    return row


def train_conf(compute_dtype: str, fused_bwd: bool = True):
    """The JAX package's flagship training configuration (bench.py:558-567
    with `_mixed`): the full-width charTransformer with sparse labels, the
    fused updater, block skip and the fused attention backward, flash
    attention on every layer, in `compute_dtype` over f32 weights, at
    learning rate TRAIN_LR."""
    from deeplearning4j_tpu_torch.models.zoo import char_transformer

    conf = char_transformer(SLICE["vocab"], d_model=SLICE["d_model"],
                            n_blocks=SLICE["n_blocks"],
                            n_heads=SLICE["n_heads"],
                            max_seq_len=SLICE["seq"], sparse_labels=True,
                            fused_updater=True, attention_block_skip=True,
                            attention_fused_bwd=fused_bwd)
    conf = conf.with_compute_dtype(compute_dtype)
    return conf.replace(confs=tuple(c.replace(attention_impl="flash",
                                              lr=TRAIN_LR)
                                    for c in conf.confs))


def phase_train(torch, kernels):
    """`MultiLayerNetwork.fit` on the full-width charTransformer in bf16
    compute, one batch of TRAIN_ROWS x 512 tokens made as bench.py:571-574
    makes it, TRAIN_STEPS calls of one Adam step each; then the fused
    attention backward against the recompute path on the same weights in
    f32. Returns the launches of every kernel over the training steps."""
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        network_loss)
    from deeplearning4j_tpu_torch.optimize.solver import from_loss
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    vocab, seq = SLICE["vocab"], SLICE["seq"]
    net = MultiLayerNetwork(train_conf("bfloat16"), device="cuda",
                            seed=0).init()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (TRAIN_ROWS, seq + 1))
    x = ids[:, :-1].astype(np.int32)
    y = ids[:, 1:].reshape(TRAIN_ROWS * seq).astype(np.int32)
    scores = [net.score(x, y)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_launches = [], []
    total = {name: 0 for name in kernels.LAUNCHES}
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        kernels.reset_launches()
        start.record()
        net.fit(x, y)
        stop.record()
        torch.cuda.synchronize()
        step_launches.append(dict(kernels.LAUNCHES))
        for name, n in kernels.LAUNCHES.items():
            total[name] += n
        step_ms.append(start.elapsed_time(stop))
        scores.append(net.score(x, y))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile_step(torch, kernels, net, x, y)
    n_attn = SLICE["n_blocks"]
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]

    # the fused backward against the recompute path, f32 compute, 2 rows
    xs = torch.as_tensor(x[:2], device="cuda")
    ys = torch.as_tensor(y[:2 * seq], device="cuda")
    grads = {}
    for fused in (True, False):
        conf = train_conf("", fused_bwd=fused)
        objective = from_loss(lambda p, c=conf: network_loss(c, p, xs, ys))
        g, _ = objective.grad_and_score(net.params)
        grads[fused] = tree_leaves(g)
    ratios = []
    for a, b in zip(grads[True], grads[False]):
        gmax = b.abs().max().item()
        err = (a - b).abs().max().item()
        ratios.append(err / gmax if gmax > 0 else (0.0 if err == 0 else
                                                   float("inf")))
    del grads
    torch.cuda.empty_cache()

    row = {"phase": "train", "config": SLICE, "compute_dtype": "bfloat16",
           "rows": TRAIN_ROWS, "tokens_per_step": TRAIN_ROWS * seq,
           "updater": "adam", "lr": TRAIN_LR, "fused_updater": True,
           "fused_bwd": True,
           "params": sum(t.numel() for t in tree_leaves(net.params)),
           "scores": scores, "step_ms": step_ms, "step_ms_median_2_on": steady,
           "tokens_per_s": TRAIN_ROWS * seq / (steady / 1e3),
           "launches_per_step": step_launches, "peak_mem_gb": peak_gb,
           "grad_check_rows": 2, "grad_check_dtype": "float32",
           "grad_fused_vs_recompute_max_rel": max(ratios)}
    emit(row)
    check(all(np.isfinite(s) for s in scores), f"non-finite score: {scores}")
    check(scores[-1] < scores[0], f"the score did not fall: {scores}")
    for launches in step_launches:
        for name in ("flash_attn_fwd",) + BWD_KERNELS:
            check(launches[name] == n_attn,
                  f"a step launched {name} {launches[name]} times, want "
                  f"{n_attn}: {launches}")
    check(max(ratios) <= 1e-3,
          f"fused and recompute gradients differ: {max(ratios)} of max|g|")
    return total


# -------------------------------------------------------------------- LSTM

#: the bench's 4-layer char-LSTM (bench.py:252-261 with n_layers=4, the
#: north star of BASELINE configs[1]): _mixed(char_lstm(50, hidden=256,
#: n_layers=4, sparse_labels=True, embed=256)), seq 64, batch 256
LSTM = dict(vocab=50, hidden=256, n_layers=4, embed=256, seq=64, rows=256)
LSTM_STEPS = 5
#: the CLI north star (bench.py:1704-1721): a 65,536-character word corpus
#: from RandomState(0), text scheme windows of 32
CLI_SEQ, CLI_CHARS = 32, 65_536
CORPUS_WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy",
                "dogs", "and", "cats", "read", "write", "code", "tpu"]


def word_corpus(chars: int = CLI_CHARS) -> str:
    """The CLI north star's corpus, built as bench.py:1706-1712 builds it
    (65,527 characters, 27 distinct)."""
    rng = np.random.RandomState(0)
    return " ".join(rng.choice(CORPUS_WORDS)
                    for _ in range(chars // 5))[:chars]


def lstm_bound_ms(b, i, h, dtype_name):
    """max(operations / peak rate, bytes / HBM rate) for one cell: the
    [B, I + H] x [I + H, 4H] product; x, h, c, Wx, Wh, b read once, h' and
    c' written once."""
    size = 2 if dtype_name == "bfloat16" else 4
    flops = 2.0 * b * (i + h) * 4 * h
    nbytes = size * (b * i + 2 * b * h + (i + h) * 4 * h + 4 * h + 2 * b * h)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def lstm_cell_inputs(torch, gen, b, i, h, dt, view):
    """x, h, c, wx, wh, bias on the card; wx and wh are the two row blocks
    of one [I + H, 4H] W (views, as the layer passes them) or copies."""
    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    device="cuda")).to(dt)

    x, h0, c0 = randn(b, i), randn(b, h), randn(b, h)
    w = randn(i + h, 4 * h, scale=0.1)
    wx, wh = (w[:i], w[i:]) if view else (w[:i].clone(), w[i:].clone())
    return x, h0, c0, wx, wh, randn(4 * h, scale=0.1)


def torch_cell_weights(torch, wx, wh, bias):
    """The same cell's weights in `torch.lstm_cell`'s layout: gate rows
    [i | f | g | o] (ours are columns [i | f | o | g]), transposed."""
    h = wh.shape[0]
    perm = torch.cat([torch.arange(0, 2 * h), torch.arange(3 * h, 4 * h),
                      torch.arange(2 * h, 3 * h)]).to(wx.device)
    return (wx[:, perm].t().contiguous(), wh[:, perm].t().contiguous(),
            bias[perm].contiguous(), torch.zeros_like(bias))


def lstm_layer_ms(torch, kernels):
    """Layer level, one [256, 64, 256] f32 sequence: the port's LSTM layer
    (fused: 64 kernel launches; scan) against cuDNN's `nn.LSTM` on the same
    weights. The layer paths by graph replay, cuDNN by eager events (one
    call); outputs compared for the record."""
    from deeplearning4j_tpu_torch.nn.conf import (LayerType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers.lstm import LSTMLayer

    b, t, n = 256, 64, 256
    gen = torch.Generator(device="cuda").manual_seed(3)
    xs = torch.randn(b, t, n, generator=gen, device="cuda")
    _, _, _, wx, wh, bias = lstm_cell_inputs(torch, gen, 1, n, n,
                                             torch.float32, False)
    params = {"W": torch.cat([wx, wh]), "b": bias}
    out = {}
    for impl in ("fused", "scan"):
        conf = NeuralNetConfiguration(layer_type=LayerType.LSTM, n_in=n,
                                      n_out=n, lstm_impl=impl)

        def fwd(conf=conf):
            with torch.inference_mode():
                return LSTMLayer.forward(params, conf, xs)

        out[impl] = fwd()
        out[impl + "_ms"] = graph_ms(fwd, iters=3, replays=2)
    cudnn = torch.nn.LSTM(n, n, batch_first=True).to("cuda")
    w_ih, w_hh, b_ih, b_hh = torch_cell_weights(torch, wx, wh, bias)
    with torch.no_grad():
        for name, val in (("weight_ih_l0", w_ih), ("weight_hh_l0", w_hh),
                          ("bias_ih_l0", b_ih), ("bias_hh_l0", b_hh)):
            getattr(cudnn, name).copy_(val)

    def lib():
        with torch.no_grad():
            return cudnn(xs)[0]

    want = lib()
    torch.cuda.synchronize()
    return {"shape": [b, t, n], "fused_ms": out["fused_ms"],
            "scan_ms": out["scan_ms"], "cudnn_lstm_call_ms": cuda_ms(lib),
            "fused_vs_cudnn_max_abs_err":
                (out["fused"] - want).abs().max().item(),
            "fused_vs_scan_max_abs_err":
                (out["fused"] - out["scan"]).abs().max().item()}


def phase_lstm_kernel(torch, kernels):
    """The fused cell against its plain version on the card in five cases
    (f32 at the bench shape, on W's row-block views, at the CLI's ragged
    shape, at a tiny ragged shape; bf16 at the bench shape), timed with the
    plain version and `torch.lstm_cell`; then the layer-level note. Returns
    the bench case's row."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("bench", 256, 256, 256, f32, False),
             ("bench_views", 256, 256, 256, f32, True),
             ("cli", 2047, 27, 128, f32, False),
             ("ragged", 3, 7, 20, f32, False),
             ("bench_bf16", 256, 256, 256, bf16, False)]
    ptxas = [line.strip() for line in
             kernels.BUILD_LOGS.get("lstm_cell", "").splitlines()
             if "registers" in line or "spill" in line]
    rows = {}
    for name, b, i, h, dt, view in cases:
        args = lstm_cell_inputs(torch, gen, b, i, h, dt, view)
        got = kernels.lstm_cell(*args)
        want = kernels.lstm_cell_reference(*args)
        torch.cuda.synchronize()
        errs = [(g.float() - w.float()).abs().max().item()
                for g, w in zip(got, want)]
        if dt == f32:
            ok = all(bool(torch.allclose(g, w, atol=1e-5, rtol=1e-5))
                     for g, w in zip(got, want))
        else:
            ok = all(e <= 2e-2 * w.float().abs().max().item()
                     for e, w in zip(errs, want))
        x, h0, c0, wx, wh, bias = args
        w_ih, w_hh, b_ih, b_hh = torch_cell_weights(torch, wx, wh, bias)

        def lib():
            return torch.lstm_cell(x, (h0, c0), w_ih, w_hh, b_ih, b_hh)

        lib_h = lib()[0]
        dname = str(dt).replace("torch.", "")
        bound_ms, bound_by = lstm_bound_ms(b, i, h, dname)
        row = {"phase": "lstm_kernel", "case": name, "shape_bih": [b, i, h],
               "dtype": dname, "w_views": view, "max_abs_err": max(errs),
               "ok": ok,
               "kernel_ms": graph_ms(lambda: kernels.lstm_cell(*args)),
               "call_ms": cuda_ms(lambda: kernels.lstm_cell(*args)),
               "plain_ms": graph_ms(
                   lambda: kernels.lstm_cell_reference(*args)),
               "library_ms": graph_ms(lib),
               "library_h_max_abs_err":
                   (lib_h.float() - want[0].float()).abs().max().item(),
               "bound_ms": bound_ms, "bound_by": bound_by, "ptxas": ptxas}
        emit(row)
        check(ok, f"lstm_cell disagrees with its plain version: {row}")
        rows[name] = row
        del args, got, want, x, h0, c0, wx, wh, bias
    layer = lstm_layer_ms(torch, kernels)
    emit({"phase": "lstm_layer", **layer})
    check(layer["fused_vs_scan_max_abs_err"] < 1e-4,
          f"the fused and scan layers differ: {layer}")
    torch.cuda.empty_cache()
    return rows["bench"], layer


def lstm_conf(impl: str = "auto", compute_dtype: str = "bfloat16"):
    """The bench's char-LSTM configuration, with `lstm_impl` set on every
    layer ("auto" is the kernel on the card)."""
    from deeplearning4j_tpu_torch.models.zoo import char_lstm

    conf = char_lstm(LSTM["vocab"], hidden=LSTM["hidden"],
                     n_layers=LSTM["n_layers"], sparse_labels=True,
                     embed=LSTM["embed"])
    conf = conf.replace(confs=tuple(c.replace(lstm_impl=impl)
                                    for c in conf.confs))
    return conf.with_compute_dtype(compute_dtype) if compute_dtype else conf


def lstm_batch():
    """The first LSTM["rows"] windows of seq + 1 characters of the word
    corpus as ids (sorted character order): x [rows, seq], y [rows * seq]."""
    text = word_corpus()
    index = {c: k for k, c in enumerate(sorted(set(text)))}
    rows, seq = LSTM["rows"], LSTM["seq"]
    ids = np.asarray([index[c] for c in text[:rows * (seq + 1)]],
                     np.int32).reshape(rows, seq + 1)
    return ids[:, :-1].copy(), ids[:, 1:].reshape(-1).copy()


def event_ms(torch, fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def phase_lstm_train(torch, kernels):
    """`MultiLayerNetwork.fit` on the bench's 4-layer char-LSTM: LSTM_STEPS
    one-step calls (SGD with momentum, lr 0.1), a score after each, and one
    `output`; every forward must launch the cell kernel n_layers * seq
    times. Then one profiled step, the fused path against the scan path in
    f32 (outputs and gradients), and both paths' step and forward times in
    turns. Returns the main path's launches."""
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        network_loss,
                                                        network_output)
    from deeplearning4j_tpu_torch.optimize.solver import from_loss
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    net = MultiLayerNetwork(lstm_conf(), device="cuda", seed=0).init()
    x, y = lstm_batch()
    per_fwd = LSTM["n_layers"] * LSTM["seq"]
    chars = LSTM["rows"] * LSTM["seq"]
    scores = [net.score(x, y)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_ms, fwd_launches = [], []
    for _ in range(LSTM_STEPS):
        before = kernels.LAUNCHES["lstm_cell"]
        step_ms.append(event_ms(torch, lambda: net.fit(x, y)))
        mid = kernels.LAUNCHES["lstm_cell"]
        scores.append(net.score(x, y))
        fwd_launches += [mid - before, kernels.LAUNCHES["lstm_cell"] - mid]
    before = kernels.LAUNCHES["lstm_cell"]
    out = net.output(x)
    torch.cuda.synchronize()
    fwd_launches.append(kernels.LAUNCHES["lstm_cell"] - before)
    launches = kernels.LAUNCHES["lstm_cell"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(tuple(out.shape) == (chars, LSTM["vocab"]),
          f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "output has non-finite values")
    profile = profile_step(torch, kernels, net, x, y,
                           phase="lstm_train_profile", ours_key="lstm_cell")

    # the kernel path against the hoisted scan in f32, on these weights
    xs = torch.as_tensor(x, device="cuda")
    ys = torch.as_tensor(y, device="cuda")
    outs, grads = {}, {}
    for impl in ("fused", "scan"):
        conf = lstm_conf(impl, compute_dtype="")
        with torch.inference_mode():
            outs[impl] = network_output(conf, net.params, xs)
        objective = from_loss(lambda p, c=conf: network_loss(c, p, xs, ys))
        grads[impl] = tree_leaves(objective.grad_and_score(net.params)[0])
    out_err = (outs["fused"] - outs["scan"]).abs().max().item()
    out_max = outs["scan"].abs().max().item()
    ratios = []
    for a, b in zip(grads["fused"], grads["scan"]):
        gmax = b.abs().max().item()
        err = (a - b).abs().max().item()
        ratios.append(err / gmax if gmax > 0 else (0.0 if err == 0 else
                                                   float("inf")))
    del outs, grads

    # both paths' train step and forward, in turns (fused, scan, scan,
    # fused), each on a copy of the weights: two warm calls, two timed
    turns = {"fused": {"step_ms": [], "output_ms": []},
             "scan": {"step_ms": [], "output_ms": []}}
    for impl in ("fused", "scan", "scan", "fused"):
        other = MultiLayerNetwork(lstm_conf(impl), device="cuda", seed=0)
        other.params = tuple({k: v.clone() for k, v in layer.items()}
                             for layer in net.params)
        for k in range(4):
            ms = event_ms(torch, lambda: other.fit(x, y))
            if k >= 2:
                turns[impl]["step_ms"].append(ms)
        turns[impl]["output_ms"].append(
            cuda_ms(lambda: other.output(x), iters=3, warmup=1))
        del other
    torch.cuda.empty_cache()

    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    row = {"phase": "lstm_train", "config": LSTM, "compute_dtype": "bfloat16",
           "updater": "sgd+momentum", "lr": 0.1,
           "params": sum(t.numel() for t in tree_leaves(net.params)),
           "scores": scores, "step_ms": step_ms,
           "step_ms_median_2_on": steady,
           "chars_per_s": chars / (steady / 1e3),
           "launches_per_forward": fwd_launches, "launches": launches,
           "peak_mem_gb": peak_gb, "idle_share": profile["idle_share"],
           "f32_fused_vs_scan_output_max_abs_err": out_err,
           "f32_fused_vs_scan_output_max": out_max,
           "f32_fused_vs_scan_grad_max_rel": max(ratios),
           "turns": turns}
    emit(row)
    check(all(np.isfinite(s) for s in scores), f"non-finite score: {scores}")
    check(scores[-1] < scores[0], f"the score did not fall: {scores}")
    check(all(n == per_fwd for n in fwd_launches),
          f"a forward launched lstm_cell {fwd_launches}, want {per_fwd} each")
    check(out_err <= 1e-5 * out_max,
          f"fused and scan outputs differ by {out_err} (max {out_max})")
    check(max(ratios) <= 1e-3,
          f"fused and scan gradients differ: {max(ratios)} of max|g|")
    return launches


def phase_lstm_cli(torch, kernels):
    """The CLI north star in process: `train` over the word corpus with
    bench.py:1716-1719's arguments, then `predict` and `test` on the
    checkpoint. Checks the JSON lines, that each command launched the cell
    kernel, and that predict's probabilities equal a direct `net.output`
    on the loaded checkpoint. Returns the launches of the three commands."""
    import contextlib
    import io
    import tempfile

    from deeplearning4j_tpu_torch.cli.driver import main as cli_main
    from deeplearning4j_tpu_torch.cli.schemes import load_input
    from deeplearning4j_tpu_torch.parallel.checkpoint import load_network

    def run(argv):
        buf = io.StringIO()
        before = kernels.LAUNCHES["lstm_cell"]
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(rc == 0, f"cli {argv[0]} exited {rc}")
        last = json.loads(buf.getvalue().strip().splitlines()[-1])
        return last, kernels.LAUNCHES["lstm_cell"] - before, wall

    with tempfile.TemporaryDirectory() as td:
        with open(f"{td}/corpus.txt", "w") as f:
            f.write(word_corpus())
        uri = f"text:{td}/corpus.txt:{CLI_SEQ}"
        ckpt, csv_path = f"{td}/lstm4", f"{td}/pred.csv"
        kernels.reset_launches()
        train, l_train, w_train = run(
            ["train", "--input", uri, "--zoo",
             "char_lstm:layers=4,hidden=128", "--output", ckpt,
             "--properties", "epochs=1"])
        pred, l_pred, w_pred = run(["predict", "--input", uri, "--model",
                                    ckpt, "--output", csv_path])
        test, l_test, w_test = run(["test", "--input", uri, "--model",
                                    ckpt])
        launches = kernels.LAUNCHES["lstm_cell"]
        data = load_input(uri)
        net = load_network(ckpt)
        direct = net.output(data.features).float().cpu().numpy()
        probs = np.loadtxt(csv_path, delimiter=",", skiprows=1,
                           dtype=np.float64)[:, 1:]
    err = float(np.abs(probs - direct).max())
    n_win = data.num_examples()
    row = {"phase": "lstm_cli", "windows": n_win, "seq": CLI_SEQ,
           "vocab": int(data.vocab_size), "train": train,
           "chars_per_s": train["examples_per_sec"] * CLI_SEQ,
           "predict": pred, "test": test,
           "launches": {"train": l_train, "predict": l_pred, "test": l_test},
           "wall_s": {"train": w_train, "predict": w_pred, "test": w_test},
           "predict_vs_direct_max_abs_err": err}
    emit(row)
    check(set(train) == {"saved", "score", "train_seconds",
                         "examples_per_sec"} and np.isfinite(train["score"]),
          f"train line {train}")
    check(pred["n"] == n_win * CLI_SEQ, f"predict line {pred}")
    check(set(test) == {"accuracy", "f1"}
          and 0.0 <= test["accuracy"] <= 1.0, f"test line {test}")
    check(min(l_train, l_pred, l_test) > 0,
          f"a command never launched the cell kernel: {row['launches']}")
    check(probs.shape == direct.shape and err <= 2e-6,
          f"predict differs from net.output by {err}")
    return launches



# ---------------------------------------------------------------- word2vec

#: the bench's Word2Vec (bench.py:368-385, nothing cut): vocab 10,000, 1.2M
#: zipf tokens in sentences of 20, vector 128, window 5, negative 5,
#: hierarchical softmax on, batch 32,768, 6 epochs, seed 0
W2V = dict(vocab=10_000, tokens=1_200_000, sent_len=20, vector=128, window=5,
           negative=5, batch=32_768, epochs=6, seed=0)
#: gathers (so scatter-add launches) per step: syn0, syn1 and syn1neg (the
#: contexts and negatives in one gather); GloVe: w, wt, b, bt
W2V_GATHERS, GLOVE_GATHERS = 3, 4


def bench_sentences():
    """The bench's corpus, made as bench.py:368-381 makes it: 60,000
    sentences of 20 zipf-drawn words w0..w9999."""
    rng = np.random.RandomState(0)
    v, n, sl = W2V["vocab"], W2V["tokens"], W2V["sent_len"]
    freq = 1.0 / np.arange(1, v + 1)
    tokens = rng.choice(v, size=n, p=freq / freq.sum())
    words = np.array([f"w{i}" for i in range(v)])
    return [list(words[tokens[i:i + sl]]) for i in range(0, n, sl)]


def bench_word2vec(**overrides):
    """The bench's Word2Vec (bench.py:383-385) on the card, with
    `overrides` of its keyword arguments."""
    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec

    kw = dict(vector_length=W2V["vector"], window=W2V["window"],
              negative=W2V["negative"], min_word_frequency=1,
              epochs=W2V["epochs"], seed=W2V["seed"],
              batch_size=W2V["batch"], device="cuda")
    return Word2Vec(**{**kw, **overrides})


def w2v_fixed_batch(torch, sents):
    """A model with the bench's vocabulary (built as `fit` builds it, so its
    fresh tables equal the tables `fit` starts from) and one fixed batch of
    the bench's shape on the card: the first W2V["batch"] pairs of a pair
    draw from another seed, and negatives from the unigram table. Returns
    (model, centers, contexts, neg, vocab arrays)."""
    from deeplearning4j_tpu_torch.text.corpus import TokenCorpus

    model = bench_word2vec()
    toks = TokenCorpus(sents, model.tokenize)
    model.build_vocab(toks)
    model._rng = np.random.RandomState(1)
    ids = [np.asarray([model.cache.index_of(t) for t in s], np.int32)
           for s in toks]
    centers, contexts = model._pairs(ids)
    pick = np.random.RandomState(2).permutation(len(centers))[:W2V["batch"]]
    vocab = model._vocab_arrays()
    gen = torch.Generator(device="cuda").manual_seed(3)
    slots = torch.randint(0, vocab[3].shape[0],
                          (W2V["batch"], W2V["negative"]), generator=gen,
                          device="cuda")
    c = torch.as_tensor(centers[pick], device="cuda")
    x = torch.as_tensor(contexts[pick], device="cuda")
    return model, c, x, vocab[3][slots], vocab


def w2v_batch_loss(torch, tables, centers, contexts, neg, vocab) -> float:
    """The port's loss function on the fixed batch, per pair."""
    from deeplearning4j_tpu_torch.models.word2vec import w2v_loss

    codes, points, mask, _ = vocab
    with torch.no_grad():
        loss = w2v_loss(tables["syn0"], tables["syn1"], tables["syn1neg"],
                        centers, contexts, codes[contexts], points[contexts],
                        mask[contexts], neg)
    return loss.item() / centers.shape[0]


def scatter_bound_ms(torch, table, idx, upd):
    """max(bytes / HBM rate, adds / f32 rate) for one scatter-add: the
    updates and indices read once, each table row this input touches read
    and written once; one add per update element. Returns (ms, bound_by,
    touched rows)."""
    rows = table.shape[0]
    touched = torch.unique(idx[(idx >= 0) & (idx < rows)]).numel()
    width = upd.numel() // max(1, upd.shape[0])
    size = table.element_size()
    nbytes = (upd.numel() * size + idx.numel() * idx.element_size()
              + 2 * touched * width * size)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = upd.numel() / PEAK_FLOPS["float32"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes", touched)


def scatter_close(torch, kernels, table, idx, upd, got, want):
    """(max |got - want|, ok) where ok holds |got - want| <= 2 n u S element
    by element: S = |table| + the sum of |upd| over the row's updates, n the
    row's adds plus one, u the dtype's unit roundoff. That is the error
    bound of a sum taken in any order, for the kernel (whose atomics add in
    an order that changes from run to run) and its plain version together."""
    u = 2.0 ** -24 if table.dtype == torch.float32 else 2.0 ** -8
    rows = table.shape[0]
    s = kernels.scatter_add_rows_reference(table.abs().float(), idx,
                                           upd.abs().float())
    n = torch.bincount(idx[(idx >= 0) & (idx < rows)].long(),
                       minlength=rows).float() + 1
    if table.dim() == 2:
        n = n[:, None]
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= 2 * n * u * s).all())


def phase_scatter_kernel(torch, kernels, centers, contexts, neg, points):
    """The scatter-add kernel against its plain version on the card at the
    word2vec step's shapes (indices from the bench's vocabulary and a batch
    of its pairs): syn1 (the pairs' Huffman points, 622,592 rows into 9,999,
    the root on every path), syn0 (32,768 centers), syn1neg (contexts and
    negatives, 196,608 rows); a GloVe bias (D = 1), a tiny ragged case with
    duplicates and out-of-range indices, and bf16. Each twice: integer-valued
    inputs, where any order of adds is exact, must give equal tables; random
    inputs are held to `scatter_close` and timed (graph replay) beside the
    plain version, `index_add_` and the bound. Returns {case: row}."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    vocab_n = W2V["vocab"]
    d = W2V["vector"]
    ragged_idx = torch.tensor([3, 0, 3, -1, 7, 6, 3, 99, 0, 2, 3, 6, 1],
                              device="cuda")
    cases = [
        ("syn1", vocab_n - 1, d, points[contexts].reshape(-1), torch.float32),
        ("syn0", vocab_n, d, centers, torch.float32),
        ("syn1neg", vocab_n, d,
         torch.cat([contexts[:, None], neg], 1).reshape(-1), torch.float32),
        ("glove_bias", vocab_n, 0, centers, torch.float32),
        ("ragged", 7, 5, ragged_idx, torch.float32),
        ("bf16", vocab_n, d,
         torch.randint(0, vocab_n, (W2V["batch"],), generator=gen,
                       device="cuda", dtype=torch.int32), torch.bfloat16)]
    ptxas = [line.strip() for line in
             kernels.BUILD_LOGS.get("scatter_add", "").splitlines()
             if "registers" in line or "spill" in line]
    rows = {}
    for name, r, width, idx, dt in cases:
        shape = (r, width) if width else (r,)
        ushape = (idx.shape[0], width) if width else (idx.shape[0],)

        def draw(shape, integer):
            if integer:
                return torch.randint(-4, 5, shape, generator=gen,
                                     device="cuda").to(dt)
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        ti, ui = draw(shape, True), draw(ushape, True)
        exact = torch.equal(kernels.scatter_add_rows(ti, idx, ui),
                            kernels.scatter_add_rows_reference(ti, idx, ui))
        table, upd = draw(shape, False), draw(ushape, False)
        got = kernels.scatter_add_rows(table, idx, upd)
        want = kernels.scatter_add_rows_reference(table, idx, upd)
        torch.cuda.synchronize()
        err, close = scatter_close(torch, kernels, table, idx, upd, got, want)
        in_range = bool(((idx >= 0) & (idx < r)).all())
        scratch = table.clone()
        bound_ms, bound_by, touched = scatter_bound_ms(torch, table, idx, upd)
        row = {"phase": "scatter_kernel", "case": name, "rows": r,
               "width": width or 1, "n": int(idx.shape[0]),
               "index_dtype": str(idx.dtype).replace("torch.", ""),
               "dtype": str(dt).replace("torch.", ""),
               "touched_rows": touched,
               "max_dup": int(torch.bincount(
                   idx[(idx >= 0) & (idx < r)].long()).max().item()),
               "exact_on_integers": exact, "max_abs_err": err,
               "max_abs_want": want.float().abs().max().item(),
               "within_sum_bound": close, "ok": exact and close,
               "kernel_ms": graph_ms(lambda: kernels.scatter_add_rows_(
                   scratch, idx, upd)),
               "call_ms": cuda_ms(lambda: kernels.scatter_add_rows_(
                   scratch, idx, upd)),
               "plain_ms": graph_ms(lambda: kernels.scatter_add_rows_reference(
                   table, idx, upd), iters=5, replays=1),
               # index_add_ asserts on the device at an out-of-range index
               "library_ms": (graph_ms(lambda: scratch.index_add_(0, idx, upd))
                              if in_range else None),
               "bound_ms": bound_ms, "bound_by": bound_by, "ptxas": ptxas}
        emit(row)
        check(row["ok"], f"scatter_add_rows disagrees with its plain "
                         f"version: {row}")
        rows[name] = row
        del ti, ui, table, upd, got, want, scratch
    torch.cuda.empty_cache()
    return rows


def count_calls(module, name, events=None):
    """Wrap module.name so that each call is counted (and, with `events`, is
    bracketed by CUDA events appended there); returns (counter, restore)."""
    import torch

    real = getattr(module, name)
    counter = {"calls": 0}

    def wrapped(*a, **kw):
        counter["calls"] += 1
        if events is None:
            return real(*a, **kw)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a, **kw)
        stop.record()
        events.append((start, stop))
        return out

    setattr(module, name, wrapped)
    return counter, lambda: setattr(module, name, real)


def profile_w2v_steps(torch, kernels, model, batch, steps=3):
    """`steps` more word2vec steps on the fixed batch under `torch.profiler`
    (alpha at min_alpha): device time by kernel, the scatter kernel's share,
    idle share. Launches made here are not counted as the main path's."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.models.word2vec import SYN_KEYS

    centers, contexts, neg, vocab = batch
    tables = {k: getattr(model.table, k) for k in SYN_KEYS}
    gen = torch.Generator(device="cuda").manual_seed(5)
    saved = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            model._batch_step(tables, gen, centers, contexts, vocab,
                              model.min_alpha)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels.LAUNCHES.update(saved)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    events.sort(key=lambda e: -e.device_time_total)
    total_us = sum(e.device_time_total for e in events)
    ours = [e for e in events if "scatter_add" in e.key]
    row = {"phase": "w2v_train_profile", "steps": steps,
           "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": total_us / 1e3 / steps,
           "idle_share": 1.0 - total_us / 1e3 / wall_ms,
           "scatter_kernel_ms_per_step":
               sum(e.device_time_total for e in ours) / 1e3 / steps,
           "kernels_per_step": sum(e.count for e in events) / steps,
           "top": [{"name": e.key[:90], "calls": e.count,
                    "ms": e.device_time_total / 1e3} for e in events[:15]]}
    emit(row)
    return row


def w2v_fit_run(torch, kernels, sents, fixed, phase, **overrides):
    """One timed `Word2Vec.fit` of the bench's configuration (with
    `overrides`): words/s as bench.py:391 computes it (tokens x epochs /
    wall, the vocab build included, a device sync at the end), the step
    time (CUDA events around each step, median), the host's pair draws, the
    scatter launches (W2V_GATHERS a step), the fixed batch's loss per pair
    before and after, and whether the tables are finite. Emits and returns
    the row and the trained model."""
    import deeplearning4j_tpu_torch.models.word2vec as w2v_mod

    probe, centers, contexts, neg, vocab = fixed
    before = w2v_batch_loss(torch, {k: getattr(probe.table, k)
                                    for k in w2v_mod.SYN_KEYS},
                            centers, contexts, neg, vocab)
    model = bench_word2vec(**overrides)
    pair_s = []
    real_pairs = model._pairs

    def timed_pairs(ids):
        t = time.perf_counter()
        out = real_pairs(ids)
        pair_s.append(time.perf_counter() - t)
        return out

    model._pairs = timed_pairs
    events = []
    counter, restore = count_calls(w2v_mod, "w2v_step", events)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        model.fit(sents)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches = kernels.LAUNCHES["scatter_add_rows"]
    steps = counter["calls"]
    step_ms = sorted(a.elapsed_time(b) for a, b in events)
    tables = {k: getattr(model.table, k) for k in w2v_mod.SYN_KEYS}
    after = w2v_batch_loss(torch, tables, centers, contexts, neg, vocab)
    row = {"phase": phase, "config": {**W2V, "epochs": model.epochs},
           "use_adagrad": model.use_adagrad, "steps": steps,
           "fit_wall_s": wall,
           "words_per_s": W2V["tokens"] * model.epochs / wall,
           "step_ms_median": step_ms[len(step_ms) // 2],
           "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
           "steps_wall_s": sum(step_ms) / 1e3,
           "pairs_host_s": pair_s,
           "launches": launches, "launches_per_step": launches / max(1, steps),
           "fixed_batch_loss_per_pair": [before, after],
           "tables_finite": all(bool(torch.isfinite(t).all())
                                for t in tables.values()),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    check(steps >= model.epochs, f"fit took {steps} steps")
    check(launches == W2V_GATHERS * steps,
          f"scatter_add_rows launched {launches} times in {steps} steps, "
          f"want {W2V_GATHERS} a step")
    return row, model


def phase_w2v_train(torch, kernels, sents, fixed):
    """The bench's Word2Vec trained at full size, nothing cut: SGD with
    alpha 0.025 decaying, 6 epochs (`w2v_fit_run`), then profiled steps.
    That configuration's summed-batch SGD diverges in the JAX package too
    (ROADMAP queue C): its tables are recorded, and must be finite with a
    falling loss only if they stay finite. Then the same widths, batch and
    corpus with the reference's per-word AdaGrad (alpha 0.025 fixed) for one
    epoch, whose tables must stay finite and whose fixed-batch loss must
    fall. Returns the launches of both fits and the first row."""
    _, centers, contexts, neg, vocab = fixed
    row, model = w2v_fit_run(torch, kernels, sents, fixed, "w2v_train")
    if row["tables_finite"]:
        before, after = row["fixed_batch_loss_per_pair"]
        check(after < before, f"the fixed batch's loss did not fall: "
                              f"{before} -> {after}")
    row["profile"] = profile_w2v_steps(torch, kernels, model,
                                       (centers, contexts, neg, vocab))
    del model
    torch.cuda.empty_cache()
    ada, model = w2v_fit_run(torch, kernels, sents, fixed,
                             "w2v_train_adagrad", use_adagrad=True, epochs=1)
    before, after = ada["fixed_batch_loss_per_pair"]
    check(ada["tables_finite"], "an AdaGrad word2vec table is not finite")
    check(after < before, f"the fixed batch's loss did not fall under "
                          f"AdaGrad: {before} -> {after}")
    del model
    torch.cuda.empty_cache()
    return row["launches"] + ada["launches"], row


def cluster_corpus(n=200, seed=0):
    """tests/test_embeddings.py:18-28: sentences of 8 words from one of two
    topic clusters, {cat, dog, pet, fur, paw} or {car, truck, road, wheel,
    engine}."""
    rng = np.random.RandomState(seed)
    animals = ["cat", "dog", "pet", "fur", "paw"]
    vehicles = ["car", "truck", "road", "wheel", "engine"]
    out = []
    for _ in range(n):
        pool = animals if rng.rand() < 0.5 else vehicles
        out.append(" ".join(rng.choice(pool, size=8)))
    return out


def phase_embed_quality(torch, kernels):
    """Word2Vec, ParagraphVectors and GloVe trained on the card on the
    two-cluster corpus with the settings of tests/test_embeddings.py, held
    to its similarity assertions; each must launch the scatter kernel once
    per gather of every step. Returns {model: launches}."""
    import deeplearning4j_tpu_torch.models.glove as glove_mod
    import deeplearning4j_tpu_torch.models.word2vec as w2v_mod
    from deeplearning4j_tpu_torch.models import (Glove, ParagraphVectors,
                                                 Word2Vec)

    def run(make, module, name, gathers):
        counter, restore = count_calls(module, name)
        kernels.reset_launches()
        try:
            t = time.perf_counter()
            model = make()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            restore()
        launches = kernels.LAUNCHES["scatter_add_rows"]
        check(counter["calls"] > 0 and launches == gathers * counter["calls"],
              f"{name}: {launches} scatter launches in {counter['calls']} "
              f"steps, want {gathers} a step")
        return model, {"steps": counter["calls"], "launches": launches,
                       "wall_s": wall}

    w2v, w2v_info = run(lambda: Word2Vec(
        vector_length=24, window=4, min_word_frequency=1, negative=4,
        epochs=4, batch_size=256, seed=1).fit(cluster_corpus()),
        w2v_mod, "w2v_step", W2V_GATHERS)
    same, cross = w2v.similarity("cat", "dog"), w2v.similarity("cat", "truck")
    near = [w for w, _ in w2v.words_nearest("cat", top=4)]
    docs = ["cat dog pet fur paw cat dog", "car truck road wheel engine",
            "dog pet paw fur cat pet", "truck car engine wheel road"]
    pv, pv_info = run(lambda: ParagraphVectors(
        vector_length=16, window=3, min_word_frequency=1, negative=3,
        epochs=8, batch_size=64, seed=4,
        labels=["an1", "ve1", "an2", "ve2"]).fit(docs),
        w2v_mod, "w2v_step", W2V_GATHERS)
    glove, glove_info = run(lambda: Glove(
        vector_length=16, window=5, min_word_frequency=1, epochs=20,
        seed=1).fit(cluster_corpus(150)), glove_mod, "glove_step",
        GLOVE_GATHERS)
    checks = {
        "w2v_same_gt_cross": [same, cross],
        "w2v_nearest_cat": near,
        "pv_an1_an2_gt_an1_ve1": [pv.doc_similarity("an1", "an2"),
                                  pv.doc_similarity("an1", "ve1")],
        "glove_cat_dog_gt_cat_engine": [glove.similarity("cat", "dog"),
                                        glove.similarity("cat", "engine")]}
    row = {"phase": "embed_quality", "word2vec": w2v_info,
           "paragraph_vectors": pv_info, "glove": glove_info,
           "checks": checks}
    emit(row)
    check(same > cross, f"word2vec: cat~dog {same} <= cat~truck {cross}")
    check(any(w in ("dog", "pet", "fur", "paw") for w in near),
          f"word2vec: nearest to cat {near}")
    a, b = checks["pv_an1_an2_gt_an1_ve1"]
    check(a > b, f"paragraph vectors: an1~an2 {a} <= an1~ve1 {b}")
    a, b = checks["glove_cat_dog_gt_cat_engine"]
    check(a > b, f"glove: cat~dog {a} <= cat~engine {b}")
    return {"word2vec": w2v_info["launches"],
            "paragraph_vectors": pv_info["launches"],
            "glove": glove_info["launches"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to test", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.nd import kernels

    card = gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "gpu": card, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    kernels.build()
    ptxas = [line.strip() for log in kernels.BUILD_LOGS.values()
             for line in log.splitlines() if "registers" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(kernels.SOURCES), "ptxas": ptxas})

    fwd_row, fwd_train_row = phase_kernels(torch, kernels)
    bwd_rows = phase_bwd_kernels(torch, kernels)
    serve_launches = phase_serve(torch, kernels)
    train_launches = phase_train(torch, kernels)
    check(serve_launches["flash_attn_fwd"] > 0, "the flash kernel never ran")
    for name in ("flash_attn_fwd",) + BWD_KERNELS:
        check(train_launches[name] > 0, f"{name} never ran in training")
    torch.cuda.empty_cache()
    lstm_row, lstm_layer = phase_lstm_kernel(torch, kernels)
    lstm_train_launches = phase_lstm_train(torch, kernels)
    lstm_cli_launches = phase_lstm_cli(torch, kernels)
    check(lstm_train_launches > 0 and lstm_cli_launches > 0,
          "the LSTM cell kernel never ran")
    torch.cuda.empty_cache()
    sents = bench_sentences()
    fixed = w2v_fixed_batch(torch, sents)
    _, centers, contexts, neg, vocab = fixed
    scatter_rows = phase_scatter_kernel(torch, kernels, centers, contexts,
                                        neg, vocab[1])
    w2v_launches, w2v_row = phase_w2v_train(torch, kernels, sents, fixed)
    del fixed, centers, contexts, neg, vocab
    quality_launches = phase_embed_quality(torch, kernels)
    check(w2v_launches > 0 and all(quality_launches.values()),
          "the scatter-add kernel never ran")

    bwd_src = "deeplearning4j_tpu_torch/csrc/flash_attn_bwd.cu"
    replaces = {"flash_bwd_delta": 229, "flash_bwd_dkv": 241,
                "flash_bwd_dq": 311}
    rows = [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "deeplearning4j_tpu/nd/pallas_kernels.py:106",
        "launches": (serve_launches["flash_attn_fwd"]
                     + train_launches["flash_attn_fwd"]),
        "launches_by_path": {"serve": serve_launches["flash_attn_fwd"],
                             "train": train_launches["flash_attn_fwd"]},
        "max_abs_err": fwd_row["max_abs_err"],
        "ms": fwd_row["kernel_ms"], "plain_ms": fwd_row["plain_ms"],
        "bound_ms": fwd_row["bound_ms"], "bound_by": fwd_row["bound_by"],
        "library_ms": fwd_row["library_ms"],
        # the numbers above are at the serving shape; the train step's
        # forward (B=32, with lse) gets its own
        "at_train_shape": {
            "max_abs_err": fwd_train_row["max_abs_err"],
            "max_abs_err_lse": fwd_train_row["max_abs_err_lse"],
            "ms": fwd_train_row["kernel_ms"],
            "plain_ms": fwd_train_row["plain_ms"],
            "bound_ms": fwd_train_row["bound_ms"],
            "bound_by": fwd_train_row["bound_by"],
            "library_ms": fwd_train_row["library_ms"]}}]
    for name in BWD_KERNELS:
        r = bwd_rows[name]
        rows.append({
            "name": name, "route": "cuda", "source": bwd_src,
            "replaces": ("deeplearning4j_tpu/nd/pallas_kernels.py:"
                         f"{replaces[name]}"),
            "launches": train_launches[name],
            "launches_by_path": {"train": train_launches[name]},
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # delta has no one-call counterpart; SDPA's backward computes
            # what delta, dK/dV and dQ compute together
            "library_ms": (None if name == "flash_bwd_delta"
                           else r["sdpa_backward_ms"]),
            "library_covers": (None if name == "flash_bwd_delta"
                               else "delta + dkv + dq")})
    rows.append({
        "name": "lstm_cell", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/lstm_cell.cu",
        "replaces": "deeplearning4j_tpu/nd/pallas_kernels.py:529",
        "launches": lstm_train_launches + lstm_cli_launches,
        "launches_by_path": {"lstm_train": lstm_train_launches,
                             "lstm_cli": lstm_cli_launches},
        "max_abs_err": lstm_row["max_abs_err"], "ms": lstm_row["kernel_ms"],
        "plain_ms": lstm_row["plain_ms"], "bound_ms": lstm_row["bound_ms"],
        "bound_by": lstm_row["bound_by"],
        # torch.lstm_cell: the same cell, in PyTorch's gate order
        "library_ms": lstm_row["library_ms"],
        # one [256, 64, 256] f32 layer: 64 launches, and cuDNN's nn.LSTM
        "layer_fused_ms": lstm_layer["fused_ms"],
        "layer_cudnn_lstm_call_ms": lstm_layer["cudnn_lstm_call_ms"]})
    syn1 = scatter_rows["syn1"]
    rows.append({
        "name": "scatter_add_rows", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/scatter_add.cu",
        "replaces": "deeplearning4j_tpu/nd/pallas_kernels.py:600",
        "launches": w2v_launches + sum(quality_launches.values()),
        "launches_by_path": {"w2v_train": w2v_launches,
                             "embed_quality": quality_launches},
        "launches_per_w2v_step": W2V_GATHERS,
        # the numbers below are at the syn1 shape of the bench's step
        "max_abs_err": syn1["max_abs_err"], "ms": syn1["kernel_ms"],
        "plain_ms": syn1["plain_ms"], "bound_ms": syn1["bound_ms"],
        "bound_by": syn1["bound_by"],
        # Tensor.index_add_: the same function in one PyTorch call
        "library_ms": syn1["library_ms"],
        "cases": {name: {k: r[k] for k in ("n", "width", "dtype",
                                           "max_abs_err", "kernel_ms",
                                           "plain_ms", "bound_ms",
                                           "library_ms")}
                  for name, r in scatter_rows.items()},
        "w2v_step_ms_median": w2v_row["step_ms_median"],
        "w2v_words_per_s": w2v_row["words_per_s"]})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
