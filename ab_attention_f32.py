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

    python3 ab_attention_f32.py --scatter-lstm [--root DIR] [--cases FILE]

times DIR's f32 scatter-add (`scatter_add_rows_`) at SCATTER_CASES (the
word2vec bench step's syn1, syn1neg and syn0 indices from
`chip_smoke.w2v_fixed_batch`, then every update in one row, uniform
indices, D = 30 with indices outside the table, zipf indices, D = 100
with int64 indices, 13 updates) and its bf16 LSTM cell at the
`chip_smoke.LSTM_CASES` bf16 shapes, each checked against its plain
version as `chip_smoke.py` checks it and timed by CUDA-graph replay beside
`index_add_` or `torch.lstm_cell` and the bound; one JSON line. FILE holds
the scatter cases' indices (written by `--variants`), so that every build
gets the same ones.

    python3 ab_attention_f32.py --variants OUT [--parent DIR]

writes copies of this checkout's package under OUT, each changed in one
place of its kernel sources (VARIANTS): the f32 D > 1 scatter's launch
rule pinned to chunks of 256, 512, 1,024 or 2,048 updates, and two probes
of the bf16 LSTM cell, without its global-to-shared copies or without its
tensor-core products (their outputs are wrong: only their times count).
It builds them, this checkout and DIR (a parent checkout: its first
scatter body) all at once, then runs `--scatter-lstm` on each in turns,
forward and back (two times a build), and prints one JSON line a run and
a last line with every case's times by build. A build whose scatter
disagrees with its plain version, or whose LSTM cell does outside the
probes, fails the run (exit 1).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
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


#: the lines of `csrc/scatter_add.cu` whose rule picks the f32 D > 1
#: body's chunk (256 updates a block times the template argument)
_RULE_4 = "  if (N >= 2LL * sms * kThreads * 4)\n"
_RULE_2 = "  if (N >= 2LL * sms * kThreads * 2)\n"
#: variant name -> (source under csrc/, [(text, replacement)])
VARIANTS = {
    "chunk_256": ("scatter_add.cu", [(_RULE_4, "  if (false)\n"),
                                     (_RULE_2, "  if (false)\n")]),
    "chunk_512": ("scatter_add.cu", [(_RULE_4, "  if (false)\n"),
                                     (_RULE_2, "  if (true)\n")]),
    "chunk_1024": ("scatter_add.cu", [(_RULE_4, "  if (true)\n")]),
    "chunk_2048": ("scatter_add.cu", [
        (_RULE_4, "  if (true)\n"),
        ("return launch_sorted<Index, 4>", "return launch_sorted<Index, 8>")]),
    # no global-to-shared copies: the products run on what the ring holds
    "lstm_no_loads": ("lstm_cell.cu", [(
        "  const bf16 zero = __float2bfloat16_rn(0.f);\n  if (vec_src) {",
        "  const bf16 zero = __float2bfloat16_rn(0.f);\n  return;\n"
        "  if (vec_src) {")]),
    # no tensor-core products: the fragments are still read by ldmatrix
    "lstm_no_products": ("lstm_cell.cu", [(
        "          mma_bf16(acc[mt][nt], a[mt], b[nt / 2][2 * (nt % 2)],\n"
        "                   b[nt / 2][2 * (nt % 2) + 1]);",
        "          ;")])}


def scatter_cases(torch):
    """SCATTER_CASES: [(name, R, D, indices on the card)]."""
    w2v = smoke.W2V
    _, centers, contexts, neg, vocab = smoke.w2v_fixed_batch(
        torch, smoke.bench_sentences())
    syn1 = vocab[1][contexts].reshape(-1)
    gen = torch.Generator(device="cuda").manual_seed(9)
    zipf = np.minimum(np.random.RandomState(7).zipf(1.2, 100_000) - 1, 9998)
    return [
        ("syn1", w2v["vocab"] - 1, w2v["vector"], syn1),
        ("syn1neg", w2v["vocab"], w2v["vector"],
         torch.cat([contexts[:, None], neg], 1).reshape(-1)),
        ("syn0", w2v["vocab"], w2v["vector"], centers),
        ("hot_row", w2v["vocab"] - 1, w2v["vector"],
         torch.zeros_like(syn1)),
        ("uniform", w2v["vocab"] - 1, w2v["vector"],
         torch.randint(0, w2v["vocab"] - 1, syn1.shape, generator=gen,
                       device="cuda")),
        ("ragged_d", 1000, 30,
         torch.randint(-2, 1002, (50_000,), generator=gen, device="cuda")),
        ("zipf", 9999, 128,
         torch.as_tensor(zipf.astype(np.int32), device="cuda")),
        ("d100_int64", 500, 100,
         torch.randint(0, 500, (25_000,), generator=gen, device="cuda")),
        ("tiny", 7, 6,
         torch.tensor([3, 0, 3, -1, 7, 6, 3, 99, 0, 2, 3, 6, 1],
                      device="cuda"))]


def scatter_lstm_main(argv, root) -> int:
    import torch

    sys.path.insert(0, root)
    from deeplearning4j_tpu_torch.nd import kernels

    kernels.build(["scatter_add", "lstm_cell"])
    if "--build-only" in argv:
        return 0
    if "--cases" in argv:
        saved = torch.load(argv[argv.index("--cases") + 1])
        cases = [(n, r, d, idx.cuda()) for n, r, d, idx in saved]
    else:
        cases = scatter_cases(torch)
    gen = torch.Generator(device="cuda").manual_seed(10)
    scatter = []
    for name, r, width, idx in cases:
        exact, err, close, (ti, ui, table, upd, got, want) = \
            smoke.scatter_check(torch, kernels, gen, r, width, idx,
                                torch.float32)
        scratch = table.clone()
        bound_ms, bound_by, touched = smoke.scatter_bound_ms(torch, table,
                                                             idx, upd)
        in_range = bool(((idx >= 0) & (idx < r)).all())
        scatter.append({
            "case": name, "rows": r, "width": width,
            "n": int(idx.shape[0]), "touched_rows": touched,
            "ok": exact and close, "max_abs_err": err,
            "kernel_ms": smoke.graph_ms(lambda: kernels.scatter_add_rows_(
                scratch, idx, upd)),
            "library_ms": (smoke.graph_ms(
                lambda: scratch.index_add_(0, idx, upd)) if in_range
                else None),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del ti, ui, table, upd, got, want, scratch
    lstm = []
    for name, b, i, h, dname, view in smoke.LSTM_CASES:
        if dname != "bfloat16":
            continue
        args = smoke.lstm_cell_inputs(torch, gen, b, i, h, torch.bfloat16,
                                      view)
        err, ok, _ = smoke.lstm_check(torch, kernels, args)
        x, h0, c0, wx, wh, bias = args
        w_ih, w_hh, b_ih, b_hh = smoke.torch_cell_weights(torch, wx, wh,
                                                          bias)
        lstm.append({
            "case": name, "shape_bih": [b, i, h], "ok": ok,
            "max_abs_err": err,
            "kernel_ms": smoke.graph_ms(lambda: kernels.lstm_cell(*args)),
            "library_ms": smoke.graph_ms(lambda: torch.lstm_cell(
                x, (h0, c0), w_ih, w_hh, b_ih, b_hh)),
            "bound_ms": smoke.lstm_bound_ms(b, i, h, "bfloat16")[0]})
    smoke.emit({"root": root, "gpu": smoke.gpu_line(), "scatter": scatter,
                "lstm_bf16": lstm})
    return 0 if all(r["ok"] for r in scatter + lstm) else 1


def write_variant(out, name):
    """A copy of this checkout's package under out/name with VARIANTS[name]
    applied; returns the copy's root."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(out, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(here, "deeplearning4j_tpu_torch"),
                    os.path.join(root, "deeplearning4j_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    source, edits = VARIANTS[name]
    path = os.path.join(root, "deeplearning4j_tpu_torch", "csrc", source)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {source} holds {text.count(old)} "
                               f"copies of {old!r}, not one")
        text = text.replace(old, new)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return root


def variants_main(argv) -> int:
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.abspath(argv[argv.index("--variants") + 1])
    os.makedirs(out, exist_ok=True)
    roots = {"rule": here}
    roots.update({name: write_variant(out, name) for name in VARIANTS})
    if "--parent" in argv:
        roots["parent"] = os.path.abspath(argv[argv.index("--parent") + 1])
    me = os.path.abspath(__file__)
    builds = {name: subprocess.Popen([sys.executable, me, "--scatter-lstm",
                                      "--build-only", "--root", root])
              for name, root in roots.items()}
    sys.path.insert(0, here)
    cases_file = os.path.join(out, "scatter_cases.pt")
    torch.save([(n, r, d, idx.cpu()) for n, r, d, idx in
                scatter_cases(torch)], cases_file)
    failed = [name for name, proc in builds.items() if proc.wait() != 0]
    if failed:
        print(f"ab_attention_f32: build failed: {failed}", file=sys.stderr)
        return 1
    order = list(roots) + list(reversed(roots))
    runs, ok = [], True
    for name in order:
        proc = subprocess.run([sys.executable, me, "--scatter-lstm", "--root",
                               roots[name], "--cases", cases_file],
                              capture_output=True, text=True, check=False)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if not lines:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        row = dict(json.loads(lines[-1]), build=name)
        smoke.emit(row)
        ok = ok and all(r["ok"] for r in row["scatter"]) and (
            name.startswith("lstm_") or all(r["ok"] for r in row["lstm_bf16"]))
        runs.append(row)
    table = {}
    for row in runs:
        for part in ("scatter", "lstm_bf16"):
            for r in row[part]:
                case = table.setdefault(part, {}).setdefault(r["case"], {
                    "library_ms": [], "bound_ms": r["bound_ms"]})
                case.setdefault(row["build"], []).append(r["kernel_ms"])
                case["library_ms"].append(r["library_ms"])
    smoke.emit({"gpu": smoke.gpu_line(), "ms_by_build": table, "ok": ok})
    return 0 if ok else 1


def main(argv) -> int:
    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    if "--root" in argv:
        root = os.path.abspath(argv[argv.index("--root") + 1])
    if not torch.cuda.is_available():
        print("ab_attention_f32: no CUDA device", file=sys.stderr)
        return 2
    if "--variants" in argv:
        return variants_main(argv)
    if "--scatter-lstm" in argv:
        return scatter_lstm_main(argv, root)
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
