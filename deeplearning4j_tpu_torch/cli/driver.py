"""CLI driver: the `train`, `test`, `predict`, `warmup`, `generate`,
`serve`, `tune`, `agent` and `analyze` subcommands.

Counterpart of `deeplearning4j_tpu/cli/driver.py`, on one device (CUDA
unless `--device cpu`):
- `train` loads `--input` (a builtin dataset, csv: or text:), builds the
  net from `--zoo` (lenet5, vgg_cifar10, mlp, char_lstm, char_transformer,
  dbn, deep_autoencoder) or `--model conf.json`, trains it
  `epochs` times over the data (whole, or in `batch`-example batches
  through the prefetcher) with `--properties epochs=N,batch=M`, and saves a
  checkpoint that either package reads. With `--checkpoint-dir` the run is
  one batch stream over every epoch, checkpointed every `checkpoint_every`
  batches (`--properties`, default 10): SIGTERM checkpoints and exits 0
  with an `interrupted` line, and a rerun with the same flags resumes. A
  net whose output loss is reconstruction cross-entropy trains and is
  scored against its inputs (batched, its stream is a
  `ReconstructionDataSetIterator`); one that is also a pretrained autoencoder
  stack runs Hinton's recipe (pretrain and unroll once, then `epochs`
  finetunes). Pretraining recipes refuse `--checkpoint-dir`, as the JAX
  package's do;
- `test` evaluates a checkpoint (accuracy, precision, recall, F1) and
  `predict` writes its argmax and class probabilities as CSV;
- `generate` loads a checkpoint of a generative model (char_lstm,
  char_transformer), captures its prefill and decode programs, and
  generates `--max-new-tokens` tokens after `--prompt` through a
  one-slot `ContinuousBatcher` (with `--page-size`, `--prefix-cache`,
  `--steps-per-dispatch` and a `--draft` checkpoint with `--spec-k` as
  its options), printing the JAX package's JSON keys;
- `serve` loads a checkpoint, sets `--precision` (f32, bf16, int8), captures
  the predict buckets of `--shapes` (default 64), starts the micro-batching
  HTTP gateway (`--no-batching`: a forward a request;
  `--default-deadline-ms`), with `--generate` also POST /v1/generate over a
  `--gen-slots` decode table (its programs, and with `--gen-draft` the
  draft's, captured before the socket opens too), prints a startup JSON
  line (`warmed`: the captured shapes; `precision` and `precision_report`)
  and on SIGTERM or SIGINT drains and prints a final JSON line;
- `warmup` loads a checkpoint (or builds a conf.json's network), attaches
  `--compile-cache`, sets `--mesh` and `--precision` and captures the
  `--shapes` buckets of `--entries` (and with `--train` the train step,
  with `--generate` the generation programs), as `serve` would. Only the
  store's byte payloads outlive it: a captured graph ends with the
  process, so `--precision int8` (its quantized weights) is the one flag
  with a lasting effect; the others check that the programs capture.
- `tune` searches the tunables registry (`optimize/tune.py`: the flash
  forward's tiles, the batcher's row target, the decode table) by
  measuring real captured programs and kernels, and stores the winning
  table in `--compile-cache` keyed by (conf fingerprint, card): every
  later process on the directory (warmup, serve, each replica) inherits it
  with fresh_tunes 0; a second `tune` inherits it too unless `--force`;
- `serve --replicas N` spawns N `serve` replica processes (each its own
  CUDA context, all on `--compile-cache`, with the caller's `--device`)
  behind the `Router` (`--hedge`, `--retry-budget`), supervised by
  `FleetSupervisor` (reap, respawn, quarantine) and, with `--max-replicas`
  above `--min-replicas`, the `Autoscaler`; `serve --agent URL` spawns them
  through `agent` processes instead (`--agent-failover`), and serves its
  own store to them over the cachesync wire (`--cache-from` on their
  command lines); SIGTERM drains the router, then the replicas;
- `agent` runs the per-host replica agent (`serving/agent.py`): it spawns
  `serve` replicas for a remote `serve --agent`, pins them to its own
  `--compile-cache` and serves that store's entries at GET /a/cache;
- `analyze` lints the port's tree against the repo's conventions and
  audits the zoo models' programs on `--device` (`analysis/`), prints one
  report (`--format text|json`, the JAX package's schema) and exits 1 when
  a finding reaches `--fail-on`; `--skip-programs` lints only.
The warmup, serve and tune JSON carry the `tuning` block
(`optimize/tunables.status()`).
Checkpoints are `conf.json` + `arrays.npz`, written by either package.

The final JSON lines keep the JAX package's keys. `train`'s: `saved`,
`score`, `resumed_from_step`, `checkpoint_write_seconds`, `train_seconds`,
`examples_per_sec`, and the caches' `compile_seconds` (capture seconds),
`cache_hits`, `cache_misses` and `infer_compile_seconds`.

`--compile-cache DIR` (every command takes it, as in the JAX package)
attaches the persistent store
(`optimize/persist.py`) to the network and its draft: it holds byte
artifacts, the int8 weights and the prefix entries, so a `serve
--precision int8` on a directory that a `warmup --precision int8` filled
loads its quantized weights and calibrates nothing. A CUDA graph is not
kept on disk: each process captures its declared programs before it
serves, and none under traffic. `disk_cache` reports the store (its
directory, entries, bytes and counters; the program counters stay 0).

`train --runtime mesh` trains through `parallel.DataParallelTrainer` over
the ranks of a `torch.distributed` group (one process a rank: torchrun's
environment, or a group of one), in batches of `batch` (default 128),
remainders padded and masked, with `mode=sync|averaging` from
`--properties`; `--zero1` shards the updater state; bare `--mesh`, `--mesh
all` and `--mesh batch=N` are the 1-D layout over N ranks, as in the JAX
package; `--mesh batch=N,model=M` trains tensor-parallel over N·M ranks
(`parallel/plan.py`; the attention and FFN blocks split over the model
axis, checkpoints in the sharded layout), as the JAX CLI does;
`--checkpoint-dir` checkpoints the trainer's whole state, and the rerun
resumes on any number of ranks and any layout. Pretraining recipes refuse
the mesh runtime as the JAX CLI does.

`serve --mesh` and `generate --mesh` serve over the ranks of the group
(`MultiLayerNetwork.set_serve_mesh`): bare `--mesh` or `all` is the 1-D
("batch",) mesh, `batch=N,model=M` the plan's. Rank 0 is the only one to
open the HTTP port, generate and print; the other ranks run its calls
(`follow`) until it ends them; every rank sets the precision policy
first.
"""

from __future__ import annotations

import argparse
import csv
import json
import signal
import sys
import time
from typing import List, Optional


def _parse_properties(props: Optional[str]) -> dict:
    """`--properties k=v,k2=v2` -> dict."""
    out = {}
    for pair in (props or "").split(","):
        if pair:
            k, _, v = pair.partition("=")
            out[k.strip()] = v.strip()
    return out


def _attach_compile_cache(net, args) -> None:
    """--compile-cache DIR: the persistent store of the network's caches
    (`MultiLayerNetwork.set_compile_cache`; a tuned table stored there for
    this conf and card installs). --cache-from URL (repeatable) adds a
    remote fallback: an entry absent from the directory is fetched from a
    peer agent or cache server over the cachesync wire
    (`serving/cachesync.py`) before it is recomputed."""
    if not getattr(args, "compile_cache", None):
        return
    sources = getattr(args, "cache_from", None)
    if not sources:
        net.set_compile_cache(args.compile_cache)
        return
    from deeplearning4j_tpu_torch.serving.cachesync import CacheFetcher

    net.set_compile_cache(args.compile_cache,
                          remote=CacheFetcher(list(sources)))


def _tuning_status() -> dict:
    """The autotuning block of the warmup/serve/tune JSON (the shape of
    `/v1/stats`'s `tuning`)."""
    from deeplearning4j_tpu_torch.optimize import tunables

    return tunables.status()


def _disk_stats(net) -> dict:
    """The disk-cache block of the CLI's JSON: the caches' program
    counters (0: a CUDA graph is not written to disk) and, with a store
    attached, its directory, entries, bytes, writes, hits and evictions;
    `fetch_hits` and `fetch_corrupt` add the store's entries fetched over
    the cachesync wire (`--cache-from`)."""
    cs, ic = net.step_cache.stats.as_dict(), net.infer_cache.stats.as_dict()
    out = {k: cs[k] + ic[k] for k in ("disk_hits", "disk_write_seconds",
                                      "deserialize_seconds", "fetch_hits",
                                      "fetch_corrupt")}
    store = net.infer_cache.persist
    if store is not None:
        out["fetch_hits"] += store.fetch_hits
        out["fetch_corrupt"] += store.fetch_corrupt
        out.update(store.stats())
    return out


def _set_precision(net, args, measure: bool = True):
    """--precision: the serve policy, set before anything is captured (on
    every rank of a serving mesh); returns its report, or None for f32."""
    precision = getattr(args, "precision", "f32")
    if precision == "f32":
        return None
    return net.set_serve_precision(precision, measure=measure)


def _cli_mesh(spec: Optional[str], device):
    """(mesh, axis, rows a batch divides into, plan) of `--runtime mesh`
    (the "dp" axis over every rank; plan None) and `--mesh SPEC`: the 1-D
    "batch" layout (plan None), or with a model axis the 2-D plan
    (`parallel/plan.py`: batch outermost, rank = b·M + m). Sizes that do
    not multiply to the ranks exit as the JAX CLI's mesh does with too
    few devices."""
    from deeplearning4j_tpu_torch.nd.platform import world_size
    from deeplearning4j_tpu_torch.parallel.mesh import (init_distributed,
                                                        make_mesh)
    from deeplearning4j_tpu_torch.parallel.plan import (ShardPlan,
                                                        parse_mesh_spec,
                                                        plan_mesh)

    init_distributed(device)  # the group, before its size is read
    if spec is None:
        mesh = make_mesh({"dp": world_size()}, device=device)
        return mesh, "dp", mesh.shape["dp"], None
    try:
        shape = parse_mesh_spec(spec)
    except ValueError as e:
        raise SystemExit(str(e))
    other = sorted(set(shape) - {"batch", "model"})
    if other:
        raise SystemExit(f"--mesh {spec}: train takes the axes 'batch' and "
                         f"'model', not {other}")
    n = world_size()
    if "model" not in shape:
        rows = shape.get("batch", -1)
        if rows > n:
            raise SystemExit(f"mesh {{'batch': {rows}}} needs {rows} ranks, "
                             f"have {n} (one process a rank, e.g. torchrun "
                             f"--nproc-per-node {rows})")
        mesh = make_mesh({"batch": rows}, device=device)
        return mesh, "batch", mesh.shape["batch"], None
    try:
        plan = ShardPlan(mesh=plan_mesh(shape, device=device))
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e} (one process a rank, e.g. "
                         f"torchrun --nproc-per-node N)")
    return plan.mesh, "batch", plan.rows, plan


def _serving_net(args):
    """(network, mesh) of `serve`/`generate`/`warmup`: without `--mesh` the
    checkpoint on `--device` and no mesh; with it, the process group first
    (torchrun's ranks, or a group of one), the network on this rank's
    device, then `set_serve_mesh(spec=...)`: bare `--mesh`/`all` the 1-D
    ("batch",) mesh, else the plan's ("batch", "model") mesh. Sizes that
    do not multiply to the ranks exit as `train --mesh` does."""
    from deeplearning4j_tpu_torch.parallel.checkpoint import load_network
    from deeplearning4j_tpu_torch.parallel.mesh import init_distributed
    from deeplearning4j_tpu_torch.parallel.plan import parse_mesh_spec

    if args.mesh is None:
        return load_network(args.model, device=args.device), None
    try:
        shape = parse_mesh_spec(args.mesh)
    except ValueError as e:
        raise SystemExit(str(e))
    other = sorted(set(shape) - {"batch", "model"})
    if other:
        raise SystemExit(f"--mesh {args.mesh}: {args.command} takes the "
                         f"axes 'batch' and 'model', not {other}")
    _, dev = init_distributed(args.device)
    net = load_network(args.model, device=dev)
    try:
        mesh = net.set_serve_mesh(spec=args.mesh)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e} (one process a rank, "
                         f"e.g. torchrun --nproc-per-node N)")
    return net, mesh


def _follows(net, mesh) -> bool:
    """On a rank other than 0 of the serving mesh: run rank 0's calls
    until it stops them, then True (the command prints nothing there)."""
    if mesh is None or mesh.rank == 0:
        return False
    net.follow()
    return True


def _load_data(args):
    from deeplearning4j_tpu_torch.cli.schemes import load_input

    return load_input(args.input, label_column=args.label_column,
                      num_examples=args.num_examples)


def _scaled(data, args):
    if args.normalize:
        data = data.normalize_zero_mean_unit_variance()
    if args.scale_01:
        data = data.scale_to_unit()
    return data


def _zoo_conf(spec: str, data):
    """--zoo 'name[:k=v,...]' -> MultiLayerConfiguration, sized from the
    loaded data (the vocabulary of the char models, the input and output
    widths of mlp: `mlp:hidden=512x512` is bench.py's 784-512-512-10 on
    MNIST; of dbn and deep_autoencoder, with the JAX CLI's defaults).
    `lenet5` takes MNIST's [B, 784] and `vgg_cifar10[:width=]` CIFAR-10's
    [B, 3072]."""
    from deeplearning4j_tpu_torch.models import zoo

    name, _, props = spec.partition(":")
    kw = dict(kv.split("=", 1) for kv in props.split(",") if kv)
    lr = float(kw.get("lr", 0.05))
    iters = int(kw.get("iterations", kw.get("iters", 1)))
    vocab = getattr(data, "vocab_size", data.features.shape[-1])
    if name == "lenet5":
        return zoo.lenet5(lr=lr, iterations=iters)
    if name == "vgg_cifar10":
        return zoo.vgg_cifar10(lr=lr, iterations=iters,
                               width=int(kw.get("width", 64)))
    if name == "mlp":
        hidden = [int(h) for h in kw.get("hidden", "64").split("x")]
        return zoo.mlp(n_in=data.features.shape[-1], hidden=hidden,
                       n_out=data.labels.shape[-1], lr=lr)
    if name == "char_lstm":
        return zoo.char_lstm(vocab, hidden=int(kw.get("hidden", 128)),
                             n_layers=int(kw.get("layers", 1)), lr=lr,
                             iterations=iters)
    if name == "char_transformer":
        seq = getattr(data, "seq_len", 0) or int(kw.get("seq_len", 256))
        return zoo.char_transformer(
            vocab, d_model=int(kw.get("d_model", 128)),
            n_blocks=int(kw.get("blocks", 2)),
            n_heads=int(kw.get("heads", 4)), max_seq_len=seq,
            lr=float(kw.get("lr", 1e-3)), iterations=iters)
    if name == "dbn":
        hidden = [int(h) for h in kw.get("hidden", "32x16").split("x")]
        return zoo.dbn(n_in=data.features.shape[-1], hidden=hidden,
                       n_out=data.labels.shape[-1], lr=lr,
                       iterations=int(kw.get("iterations",
                                             kw.get("iters", 30))),
                       k=int(kw.get("k", 1)),
                       finetune_iterations=int(kw.get("finetune", 60)))
    if name == "deep_autoencoder":
        hidden = [int(h) for h in kw.get("hidden", "64x16").split("x")]
        return zoo.deep_autoencoder(
            n_in=data.features.shape[-1], hidden=hidden, lr=lr,
            iterations=int(kw.get("iterations", kw.get("iters", 20))),
            finetune_iterations=int(kw.get("finetune", 100)))
    raise SystemExit(f"unknown --zoo model '{name}' (choose lenet5, "
                     f"vgg_cifar10, mlp, char_lstm, char_transformer, dbn "
                     f"or deep_autoencoder)")


def cmd_train(args) -> int:
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator, MultipleEpochsIterator, PrefetchIterator,
        ReconstructionDataSetIterator)
    from deeplearning4j_tpu_torch.nd.losses import LossFunction
    from deeplearning4j_tpu_torch.nn.conf import (LayerType,
                                                  MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import checkpoint
    from deeplearning4j_tpu_torch.reliability import TrainingInterrupted

    data = _load_data(args)
    if args.zoo:
        conf = _zoo_conf(args.zoo, data)
    elif args.model:
        with open(args.model) as f:
            conf = MultiLayerConfiguration.from_json(f.read())
    else:
        raise SystemExit("train needs --model <conf.json> or --zoo <name>")
    if (LayerType(str(conf.confs[0].layer_type)) == LayerType.EMBEDDING
            and data.features.ndim == 3):
        # an embedding takes int ids [B, T]; the text scheme gives one-hot
        # [B, T, V]
        ds = DataSet(data.features.argmax(-1).astype("int32"), data.labels)
        for attr in ("vocab_size", "seq_len", "char_index"):
            if hasattr(data, attr):
                setattr(ds, attr, getattr(data, attr))
        data = ds
    data = _scaled(data, args)

    props = _parse_properties(args.properties)
    epochs = int(props.get("epochs", "1"))
    batch = int(props.get("batch", "0"))
    # a reconstruction head is trained and scored against its inputs
    # (detected from the output loss, not the --zoo name, so that a --model
    # conf gets it too); with a pretrained AE stack it is Hinton's recipe
    out_lf = conf.conf(conf.n_layers - 1).loss_function
    reconstruction = (LossFunction(str(out_lf))
                      == LossFunction.RECONSTRUCTION_CROSSENTROPY)
    deep_ae = reconstruction and conf.pretrain and any(
        LayerType(str(c.layer_type)) == LayerType.AUTOENCODER
        for c in conf.confs)
    if args.runtime == "mesh" and (deep_ae or conf.pretrain):
        raise SystemExit(
            "pretraining workflows (dbn/deep_autoencoder) need "
            "--runtime local: the mesh data-parallel step is "
            "gradient-only and would silently skip layer-wise pretraining")
    if args.mesh is not None:
        args.runtime = "mesh"  # --mesh implies the mesh runtime
    if args.zero1 and args.runtime != "mesh":
        raise SystemExit("--zero1 shards updater state over the dp mesh "
                         "axis; it requires --runtime mesh (or --mesh)")
    if args.checkpoint_dir and conf.pretrain:
        raise SystemExit(
            "--checkpoint-dir does not support pretraining recipes "
            "(dbn/deep_autoencoder): their multi-phase schedule is not "
            "batch-cursor resumable")
    targets = data.features if reconstruction else data.labels
    device = args.device
    if args.runtime == "mesh":
        # the group first: it gives this rank its device (under torchrun
        # one card a rank), which the network is built on
        mesh, axis, rows, plan = _cli_mesh(args.mesh, args.device)
        device = mesh.device
    net = MultiLayerNetwork(conf, device=device).init()
    _attach_compile_cache(net, args)
    t_train = time.perf_counter()
    step_stats = net.step_cache.stats
    resumed_from_step = None
    ckpt_write_seconds = 0.0
    if args.runtime == "mesh":
        from deeplearning4j_tpu_torch.parallel.data_parallel import \
            DataParallelTrainer

        batch = int(props.get("batch", "128"))
        n = data.num_examples()
        if n < rows:
            raise SystemExit(
                f"mesh runtime needs >= {rows} examples (one per row "
                f"shard), got {n}")
        remainder = sum(b.num_examples() % rows
                        for b in data.batch_by(batch))
        if remainder:
            # remainder batches run the pad-and-mask step in every mode:
            # every example still trains
            print(f"note: {remainder} examples/epoch take the padded-batch "
                  f"path to stay divisible by the {rows}-row dp axis",
                  file=sys.stderr)
        # a plan with a model axis (tensor parallelism) takes the place of
        # mesh and axis
        trainer = DataParallelTrainer(net, mesh, axis=axis,
                                      mode=props.get("mode", "sync"),
                                      zero1=args.zero1, plan=plan)
        if args.checkpoint_dir:
            # crash-safe and elastic: the trainer's whole state (params,
            # updater moments, step, key, batch cursor) resumes on any
            # number of ranks
            try:
                trainer.fit(data.batch_by(batch), epochs=epochs,
                            checkpoint_dir=args.checkpoint_dir,
                            checkpoint_every_n_batches=int(
                                props.get("checkpoint_every", "10")))
            except TrainingInterrupted as e:
                print(json.dumps({"interrupted": True,
                                  "checkpoint": args.checkpoint_dir,
                                  "detail": str(e)}), flush=True)
                return 0
        else:
            trainer.fit(data.batch_by(batch), epochs=epochs)
        resumed_from_step = trainer.resumed_from_step
        ckpt_write_seconds = trainer.checkpoint_write_seconds
        # the trainer's steps are programs of its own cache
        step_stats = trainer.compile_cache.stats
    elif deep_ae:
        if epochs > 0:
            # pretrain and unroll once (again would overwrite the finetuned
            # decoder with the encoder's transpose); the finetune repeats
            from deeplearning4j_tpu_torch.models.zoo import \
                fit_deep_autoencoder

            fit_deep_autoencoder(net, data.features)
            for _ in range(epochs - 1):
                net.finetune(data.features, data.features)
    elif args.checkpoint_dir:
        # one batch stream over every epoch, so that the checkpoint's one
        # cursor addresses the whole run and a rerun replays the stream up
        # to it, then resumes
        if epochs > 0:
            stream = ListDataSetIterator(
                data, batch if batch > 0 else data.num_examples())
            if reconstruction:
                stream = ReconstructionDataSetIterator(stream)
            if epochs > 1:
                stream = MultipleEpochsIterator(epochs, stream)
            try:
                net.fit(PrefetchIterator(stream, device=net.device),
                        checkpoint_dir=args.checkpoint_dir,
                        checkpoint_every_n_batches=int(
                            props.get("checkpoint_every", "10")))
            except TrainingInterrupted as e:
                # checkpointed on the way out: a rerun with the same flags
                # resumes at the cursor
                print(json.dumps({"interrupted": True,
                                  "checkpoint": args.checkpoint_dir,
                                  "detail": str(e)}), flush=True)
                return 0
    else:
        for _ in range(epochs):
            if batch > 0:
                stream = ListDataSetIterator(data, batch)
                if reconstruction:
                    stream = ReconstructionDataSetIterator(stream)
                for b in PrefetchIterator(stream, device=net.device):
                    net.fit(b.features, b.labels)
            else:
                net.fit(data.features, targets)
    # each fit ends in the solver's read-back of its scores: the work is done
    train_seconds = time.perf_counter() - t_train
    score = net.score(data.features, targets)
    checkpoint.save(args.output, net.params, conf=conf,
                    metadata={"score": score, "input": args.input})
    n_trained = data.num_examples() * epochs
    if args.runtime != "mesh":
        resumed_from_step = net.resumed_from_batch
        ckpt_write_seconds = net.checkpoint_write_seconds
    cs, ic = step_stats, net.infer_cache.stats
    print(json.dumps({"saved": args.output, "score": score,
                      "resumed_from_step": resumed_from_step,
                      "checkpoint_write_seconds": round(
                          ckpt_write_seconds, 3),
                      "train_seconds": round(train_seconds, 3),
                      "examples_per_sec": round(
                          n_trained / max(train_seconds, 1e-9), 2),
                      "compile_seconds": round(cs.total_compile_seconds, 3),
                      "cache_hits": cs.hits, "cache_misses": cs.misses,
                      "infer_compile_seconds": round(
                          ic.total_compile_seconds, 3),
                      "disk_cache": _disk_stats(net)}), flush=True)
    return 0


def cmd_test(args) -> int:
    from deeplearning4j_tpu_torch.evaluation import evaluate
    from deeplearning4j_tpu_torch.parallel.checkpoint import load_network

    net = load_network(args.model, device=args.device)
    _attach_compile_cache(net, args)
    data = _scaled(_load_data(args), args)
    ev = evaluate(net, data, batch_size=args.batch)
    print(ev.stats())
    print(json.dumps({"accuracy": ev.accuracy(), "f1": ev.f1(),
                      "disk_cache": _disk_stats(net)}), flush=True)
    return 0


def cmd_predict(args) -> int:
    import numpy as np

    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator, PrefetchIterator)
    from deeplearning4j_tpu_torch.evaluation.evaluation import _host
    from deeplearning4j_tpu_torch.parallel.checkpoint import load_network

    net = load_network(args.model, device=args.device)
    _attach_compile_cache(net, args)
    data = _scaled(_load_data(args), args)
    if 0 < args.batch < data.num_examples():
        probs = np.concatenate(
            [_host(net.output(b.features)) for b in PrefetchIterator(
                ListDataSetIterator(data, args.batch), device=net.device)])
    else:
        probs = _host(net.output(data.features))
    preds = probs.argmax(axis=-1)
    if args.output:
        with open(args.output, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["prediction"] +
                       [f"p{i}" for i in range(probs.shape[1])])
            for p, row in zip(preds, probs):
                w.writerow([int(p)] + [f"{v:.6f}" for v in row])
        print(json.dumps({"written": args.output, "n": len(preds),
                          "disk_cache": _disk_stats(net)}), flush=True)
    else:
        print(" ".join(str(int(p)) for p in preds))
    return 0


def _parse_shapes(spec: str):
    """'256,1024' or '32x784' -> [int batch | full shape tuple, ...]."""
    shapes = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        dims = tuple(int(d) for d in part.split("x"))
        shapes.append(dims[0] if len(dims) == 1 else dims)
    return shapes


def _parse_buckets(spec: str):
    """'4,8' -> (4, 8): the prompt buckets the prefill programs pad into."""
    out = tuple(int(p) for p in (spec or "").split(",") if p.strip())
    if not out:
        raise SystemExit("expected a comma-separated bucket list like 4,8")
    return out


def _gen_draft_net(args, device=None):
    """--draft / --gen-draft CHECKPOINT: the loaded draft network (on the
    target's device), on the target's store, or None."""
    from deeplearning4j_tpu_torch.parallel.checkpoint import load_network

    if not getattr(args, "gen_draft", None):
        return None
    if args.gen_spec_k < 2:
        raise SystemExit("--gen-draft requires --gen-spec-k >= 2")
    draft = load_network(args.gen_draft,
                         device=args.device if device is None else device)
    _attach_compile_cache(draft, args)
    return draft


def _warm_generate(net, args, draft=None) -> dict:
    """Capture the generation programs of the gen_* flags (`serve
    --generate` and `warmup --generate`), before any traffic."""
    summary = net.warmup_generate(
        slots=args.gen_slots, max_seq=args.gen_max_seq,
        prompt_buckets=_parse_buckets(args.gen_prompt_buckets),
        page_size=args.gen_page_size, n_pages=args.gen_pages,
        prefix_cache=args.gen_prefix_cache, draft_net=draft,
        spec_k=args.gen_spec_k,
        steps_per_dispatch=args.gen_steps_per_dispatch)
    summary.pop("infer_cache")
    return summary


def cmd_warmup(args) -> int:
    """Fill `--compile-cache` ahead of traffic: the policy (`--precision`;
    for int8 its quantized weights go into the store) and the mesh
    (`--mesh`) are set first, as `serve` sets them, then the `--shapes`
    buckets of `--entries` are captured (`--train`: the train step too;
    `--generate`: the generation programs, the draft's on the target's
    store). Only the store's byte payloads outlive the process: its CUDA
    graphs end with it and `serve` captures every key again, so the int8
    weights are the one lasting effect, and the captures check that the
    programs build. Under `--mesh` rank 0 warms and prints; the other
    ranks follow its calls."""
    import os

    import numpy as np

    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if os.path.isdir(args.model) or args.mesh is not None:
        net, mesh = _serving_net(args)
    else:
        with open(args.model) as f:
            conf = MultiLayerConfiguration.from_json(f.read())
        net, mesh = MultiLayerNetwork(conf, device=args.device).init(), None
    net.set_compile_cache(args.compile_cache)
    _set_precision(net, args, measure=False)
    if _follows(net, mesh):
        return 0
    try:
        shapes = _parse_shapes(args.shapes)
        if not shapes:
            raise SystemExit("warmup needs --shapes (e.g. 256,1024 or "
                             "32x784)")
        entries = tuple(e.strip() for e in args.entries.split(",")
                        if e.strip())
        summary = net.warmup(shapes, entries=entries, train=args.train)
        if args.generate:
            summary["generation"] = _warm_generate(
                net, args, draft=_gen_draft_net(args, net.device))
            summary["infer_cache"] = net.infer_cache.stats.as_dict()
    finally:
        net.stop_followers()
    summary["precision"] = net.serve_precision
    summary["precision_report"] = net.serve_precision_report
    summary["mesh_devices"] = (None if mesh is None else
                               int(np.prod(list(mesh.shape.values()))))
    summary["disk_cache"] = _disk_stats(net)
    summary["tuning"] = _tuning_status()
    print(json.dumps(summary), flush=True)
    return 0


def cmd_tune(args) -> int:
    """Search the tunables registry's config space for this model
    (`optimize/tune.py`): measure real captured candidate programs and
    kernel tiles through the network's caches and wrappers, prune the
    analytically bad candidates, and persist the winning table in the
    store, keyed by (conf fingerprint, device kind): later warmup, serve
    and replica processes on the directory inherit it with
    fresh_tunes == 0."""
    import os

    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import tune as tune_mod
    from deeplearning4j_tpu_torch.parallel.checkpoint import load_network

    if os.path.isdir(args.model):
        net = load_network(args.model, device=args.device)
    else:
        with open(args.model) as f:
            conf = MultiLayerConfiguration.from_json(f.read())
        net = MultiLayerNetwork(conf, device=args.device).init()
    store = None
    if args.compile_cache:
        store = net.set_compile_cache(args.compile_cache)
    groups = tuple(g.strip() for g in args.groups.split(",") if g.strip())
    report = tune_mod.tune_and_store(
        net, store, force=args.force, groups=groups, rounds=args.rounds,
        seed=args.seed, max_seq=args.gen_max_seq)
    report["disk_cache"] = _disk_stats(net)
    print(json.dumps(report), flush=True)
    return 0


def cmd_generate(args) -> int:
    """Generation from a checkpoint through the cached KV-cache path: the
    prefill takes the prompt, then a one-slot `ContinuousBatcher`'s decode
    loop makes each token (`serve --generate` runs the many-slot table).
    Under `--mesh` rank 0 generates and prints; the other ranks follow."""
    net, mesh = _serving_net(args)
    _attach_compile_cache(net, args)
    if _follows(net, mesh):
        return 0
    try:
        return _generate_on_rank0(args, net)
    finally:
        net.stop_followers()


def _generate_on_rank0(args, net) -> int:
    from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher

    prompt = [int(t) for t in args.prompt.split(",") if t.strip()]
    if not prompt:
        raise SystemExit("generate needs --prompt <id,id,...>")
    if len(prompt) >= args.gen_max_seq:
        raise SystemExit(f"prompt of {len(prompt)} tokens needs "
                         f"--max-seq > {len(prompt)}")
    bucket = min(max(4, 1 << (len(prompt) - 1).bit_length()),
                 args.gen_max_seq)
    # one-shot generation decodes one stream: a one-slot table, a
    # deliberate pin that no tuned table may widen
    options = dict(max_seq=args.gen_max_seq, prompt_buckets=(bucket,),
                   page_size=args.gen_page_size,
                   prefix_cache=args.gen_prefix_cache,
                   draft_net=_gen_draft_net(args, net.device),
                   spec_k=args.gen_spec_k,
                   steps_per_dispatch=args.gen_steps_per_dispatch)
    net.warmup_generate(slots=1, **options)  # lint: allow(hardcoded-tunable)
    warmed_misses = net.infer_cache.stats.misses
    batcher = ContinuousBatcher(net, n_slots=1, **options)  # lint: allow(hardcoded-tunable)
    try:
        t0 = time.perf_counter()
        stream = batcher.submit(prompt, max_new_tokens=args.max_new_tokens,
                                temperature=args.temperature,
                                rng_seed=args.seed)
        tokens = list(stream.tokens(timeout=args.timeout))
        dt = time.perf_counter() - t0
    finally:
        batcher.stop()
    print(json.dumps({
        "tokens": tokens,
        "n_tokens": len(tokens),
        "tokens_per_sec": round(len(tokens) / max(dt, 1e-9), 2),
        "ttft_ms": (None if stream.ttft_s is None
                    else round(stream.ttft_s * 1000.0, 3)),
        "fresh_compiles": net.infer_cache.stats.misses - warmed_misses,
        "disk_cache": _disk_stats(net)}), flush=True)
    return 0


def cmd_serve(args) -> int:
    """The HTTP server; under `--mesh` on rank 0 alone, the other ranks
    following its calls. The store and the precision policy come first, on
    every rank, so that the warmed programs carry the policy's key (and an
    int8 artifact a `warmup` stored is loaded, not calibrated)."""
    if args.replicas >= 1 or args.agent:
        return cmd_serve_router(args)
    net, mesh = _serving_net(args)
    _attach_compile_cache(net, args)
    precision_report = _set_precision(net, args)
    if _follows(net, mesh):
        return 0
    try:
        return _serve_on_rank0(args, net, precision_report)
    finally:
        net.stop_followers()


def _serve_on_rank0(args, net, precision_report) -> int:
    from deeplearning4j_tpu_torch.nd.platform import device_kind

    generation = draft = warmed = None
    shapes = _parse_shapes(args.shapes)
    if shapes:
        # the predict buckets are captured before the socket opens, so
        # requests that pad into them replay and capture nothing
        warmed = net.warmup(shapes, entries=("output",))["shapes"]
    buckets = _parse_buckets(args.gen_prompt_buckets)
    if args.generate:
        # the decode and prefill programs (and the draft's) are captured
        # before the socket opens, so generation starts from cache hits
        draft = _gen_draft_net(args, net.device)
        generation = _warm_generate(net, args, draft)
    server = net.serve(host=args.host, port=args.port,
                       max_delay_ms=args.max_delay_ms,
                       max_pending=args.max_pending,
                       max_batch_rows=args.max_batch_rows,
                       batching=not args.no_batching,
                       request_timeout_s=args.request_timeout,
                       drain_timeout_s=args.drain_timeout,
                       default_deadline_ms=args.default_deadline_ms,
                       generate=args.generate, gen_slots=args.gen_slots,
                       gen_max_seq=args.gen_max_seq,
                       gen_prompt_buckets=buckets,
                       gen_max_pending=args.gen_max_pending,
                       gen_page_size=args.gen_page_size,
                       gen_pages=args.gen_pages,
                       gen_prefix_cache=args.gen_prefix_cache,
                       gen_prefix_match=args.gen_prefix_match,
                       gen_draft=draft, gen_spec_k=args.gen_spec_k,
                       gen_steps_per_dispatch=args.gen_steps_per_dispatch)
    print(json.dumps({"url": server.url, "device": str(net.device),
                      "device_kind": device_kind(net.device),
                      "plan": net.infer_cache.plan.describe(),
                      "warmed": warmed, "batching": not args.no_batching,
                      "generation": generation,
                      "fresh_compiles": net.infer_cache.stats.misses,
                      "precision": net.serve_precision,
                      "precision_report": precision_report,
                      "disk_cache": _disk_stats(net),
                      "tuning": _tuning_status()}),
          flush=True)
    # the handler only sets an event; the main thread runs the drain
    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(
                sig, lambda signum, frame: server.request_stop())
        except ValueError:
            pass  # not the main thread (embedded use): explicit stop only
    try:
        server.wait_for_stop()
    except KeyboardInterrupt:
        pass
    finally:
        server.drain(args.drain_timeout)
        for sig, handler in prev.items():
            signal.signal(sig, handler)
        st = server.stats()
        print(json.dumps({"drained": True, "requests": st["requests"],
                          "deadline_misses": st["deadline_misses"],
                          "errors": st["errors"]}), flush=True)
    return 0


def _replica_cmd(args) -> List[str]:
    """The `serve` command line one replica subprocess runs: the
    caller's flags minus --replicas, always on an ephemeral port, with the
    caller's --device (a CPU fleet spawns CPU replicas; without it each
    replica takes the card, and none falls back to the CPU)."""
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "serve",
           "--model", args.model, "--host", args.host, "--port", "0",
           "--shapes", args.shapes,
           "--max-pending", str(args.max_pending),
           "--drain-timeout", str(getattr(args, "drain_timeout", 10.0)),
           "--request-timeout", str(getattr(args, "request_timeout", 30.0))]
    if args.max_delay_ms is not None:
        # None = tunable-governed; each replica resolves its own (and a
        # shared tuned table keeps the fleet uniform)
        cmd += ["--max-delay-ms", str(args.max_delay_ms)]
    if args.compile_cache:
        cmd += ["--compile-cache", args.compile_cache]
    if args.max_batch_rows is not None:
        cmd += ["--max-batch-rows", str(args.max_batch_rows)]
    if args.no_batching:
        cmd += ["--no-batching"]
    if getattr(args, "default_deadline_ms", None) is not None:
        cmd += ["--default-deadline-ms", str(args.default_deadline_ms)]
    if getattr(args, "mesh", None) is not None:
        cmd += ["--mesh", args.mesh]
    if getattr(args, "precision", "f32") != "f32":
        cmd += ["--precision", args.precision]
    if getattr(args, "device", None):
        cmd += ["--device", args.device]
    return cmd


def _remote_serve_argv(args, cache_sources: List[str]) -> List[str]:
    """The `serve` argv a ReplicaAgent spawns for one remote replica:
    the local replica command line minus the interpreter prefix and
    minus --compile-cache (each agent pins its own host's cache dir),
    plus --cache-from URLs so a cold host warms over the cachesync wire
    instead of compiling."""
    # drop `python -m deeplearning4j_tpu_torch.cli`
    cmd = _replica_cmd(args)[3:]
    argv: List[str] = []
    skip = False
    for a in cmd:
        if skip:
            skip = False
            continue
        if a == "--compile-cache":
            skip = True
            continue
        argv.append(a)
    for src in cache_sources:
        argv += ["--cache-from", src]
    return argv


class ReplicaProcess:
    """One `serve` replica subprocess: spawn, read the startup JSON off
    its stdout (blocks until the replica warmed and is listening),
    SIGTERM + collect the drained JSON at shutdown."""

    def __init__(self, cmd: List[str]):
        import subprocess

        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
        self.summary: Optional[dict] = None

    def wait_ready(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            rc = self.proc.wait()
            raise SystemExit(f"replica died during startup (exit {rc})")
        self.summary = json.loads(line)
        return self.summary

    @property
    def url(self) -> Optional[str]:
        return None if self.summary is None else self.summary.get("url")

    @property
    def pid(self) -> int:
        return self.proc.pid

    def poll(self) -> Optional[int]:
        """Exit code if the process died, None while alive — the
        supervisor's reap probe."""
        return self.proc.poll()

    def terminate(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass

    def kill(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                pass

    def wait(self, timeout: Optional[float] = None) -> int:
        try:
            rc = self.proc.wait(timeout)
        finally:
            if self.proc.stdout is not None:
                self.proc.stdout.close()
        return rc


def cmd_serve_router(args) -> int:
    """serve --replicas N: spawn N replica subprocesses sharing the
    --compile-cache dir, front them with `serving.Router`, supervise
    them (`FleetSupervisor` reaps + respawns deaths, `Autoscaler` flexes
    the fleet between --min/--max-replicas), and mirror the
    single-server SIGTERM contract fleet-wide — drain the ROUTER first
    (every accepted request still finds its replica), then SIGTERM the
    replicas and insist they all drain to exit 0."""
    import signal

    from deeplearning4j_tpu_torch.serving.autoscaler import Autoscaler
    from deeplearning4j_tpu_torch.serving.router import Router
    from deeplearning4j_tpu_torch.serving.supervisor import FleetSupervisor

    agent_urls = list(getattr(args, "agent", None) or [])
    if agent_urls and args.replicas < 1:
        args.replicas = 1
    min_replicas = getattr(args, "min_replicas", None) or args.replicas
    max_replicas = getattr(args, "max_replicas", None) or args.replicas
    cmd = _replica_cmd(args)
    cache_server = None
    remote_argv = None
    clients = []
    if agent_urls:
        # multi-host: replicas live on per-host ReplicaAgents; the
        # supervisor drives them over the network with leases
        from deeplearning4j_tpu_torch.serving.agent import AgentClient
        from deeplearning4j_tpu_torch.serving.cachesync import CacheServer

        clients = [AgentClient(u) for u in agent_urls]
        sources = []
        if args.compile_cache:
            # the control-plane host serves its own warmed cache dir
            # too, so a respawn on a cold host warms over the wire even
            # when every peer agent is cold (or dead)
            cache_server = CacheServer(args.compile_cache).start()
            sources.append(cache_server.url)
        sources += [c.url for c in clients]
        remote_argv = _remote_serve_argv(args, sources)
        replicas = [clients[i % len(clients)].spawn(remote_argv)
                    for i in range(args.replicas)]
    else:
        replicas = [ReplicaProcess(cmd) for _ in range(args.replicas)]
    router = supervisor = autoscaler = None
    try:
        summaries = [r.wait_ready() for r in replicas]
        router = Router([s["url"] for s in summaries],
                        host=args.host, port=args.port,
                        request_timeout_s=getattr(args, "request_timeout",
                                                  30.0) + 5.0,
                        hedge=getattr(args, "hedge", False),
                        retry_budget_ratio=getattr(args, "retry_budget",
                                                   0.1)).start()
        # the supervisor adopts the already-ready initial handles; a
        # respawn re-runs the same replica command line against the same
        # shared disk cache, so coming back is seconds, not compiles
        supervisor = FleetSupervisor(
            spawn_fn=lambda: ReplicaProcess(cmd), router=router,
            initial=replicas, min_replicas=min_replicas,
            max_replicas=max_replicas,
            agents=clients, remote_argv=remote_argv,
            agent_failover_s=getattr(args, "agent_failover", 10.0),
            drain_timeout_s=getattr(args, "drain_timeout", 10.0)).start()
        if max_replicas > min_replicas:
            autoscaler = Autoscaler(
                router, supervisor,
                slo_p99_ms=getattr(args, "slo_p99_ms", 500.0)).start()
        router.attach_fleet(supervisor, autoscaler)
        print(json.dumps({
            "url": router.url,
            "replicas": [s["url"] for s in summaries],
            "replica_pids": [r.pid for r in replicas],
            "min_replicas": min_replicas,
            "max_replicas": max_replicas,
            "hedge": router.hedge,
            "agents": [c.url for c in clients],
            "fresh_compiles": [s.get("fresh_compiles") for s in summaries],
            "tuning": [s.get("tuning") for s in summaries],
            "mesh_devices": summaries[0].get("mesh_devices"),
        }), flush=True)
        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(
                    sig, lambda signum, frame: router.request_stop())
            except ValueError:
                pass  # not the main thread: explicit stop only
        try:
            router.wait_for_stop()
        except KeyboardInterrupt:
            pass
        finally:
            for sig, handler in prev.items():
                signal.signal(sig, handler)
    finally:
        drain_timeout = getattr(args, "drain_timeout", 10.0)
        # shutdown order: control plane first (no respawn or scale
        # action races the teardown), then the router drain (accepted
        # requests finish against live replicas), then SIGTERM whatever
        # processes the supervisor currently owns
        if autoscaler is not None:
            autoscaler.stop()
        if supervisor is not None:
            supervisor.stop()
        if router is not None:
            router.drain(drain_timeout)
        if cache_server is not None:
            cache_server.stop()
        handles = supervisor.handles() if supervisor is not None else replicas
        for r in handles:
            r.terminate()
        rcs = []
        for r in handles:
            try:
                rcs.append(r.wait(timeout=drain_timeout + 15.0))
            except Exception:  # noqa: BLE001 — a wedged replica: kill
                r.kill()
                rcs.append(r.wait())
        stats = router.stats() if router is not None else {}
        fleet = stats.get("fleet", {})
        print(json.dumps({"drained": True,
                          "replica_exit_codes": rcs,
                          "retries": stats.get("retries", 0),
                          "unroutable": stats.get("unroutable", 0),
                          "hedges": stats.get("hedges", 0),
                          "restarts": fleet.get("restarts_total", 0)}),
              flush=True)
    return 0 if rcs and all(rc == 0 for rc in rcs) else 1


def cmd_agent(args) -> int:
    """agent: the per-host replica-agent control plane.  Runs a small
    HTTP server (POST /a/spawn, POST /a/stop, GET /a/health,
    GET /a/replicas, GET /a/cache/{key}) that owns this host's replica
    subprocesses on behalf of a remote `serve --agent` supervisor.
    Model-free: the agent imports no torch model code -- replicas are
    ordinary `serve` subprocesses, and the agent pins each one to this
    host's --compile-cache dir so they share its entries (the tuned table,
    the int8 artifact, prefix entries) and serve them to cold peers over
    /a/cache."""
    import threading

    from deeplearning4j_tpu_torch.serving.agent import ReplicaAgent

    def spawn_fn(argv):
        return ReplicaProcess(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.cli"] + list(argv))

    agent = ReplicaAgent(spawn_fn, host=args.host, port=args.port,
                         cache_dir=args.compile_cache,
                         max_replicas=args.max_replicas).start()
    print(json.dumps({"url": agent.url,
                      "compile_cache": args.compile_cache,
                      "max_replicas": args.max_replicas}), flush=True)
    stop = threading.Event()
    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig,
                                      lambda signum, frame: stop.set())
        except ValueError:
            pass  # not the main thread: explicit stop only
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
        h = agent.health()
        rcs = agent.stop(terminate_children=True,
                         drain_timeout_s=getattr(args, "drain_timeout",
                                                 10.0) + 15.0)
        print(json.dumps({"drained": True,
                          "replica_exit_codes": rcs,
                          "spawns_total": h.get("spawns_total", 0),
                          "cache_requests_total":
                              h.get("cache_requests_total", 0),
                          "cache_hits_total": h.get("cache_hits_total", 0)}),
              flush=True)
    return 0


def cmd_analyze(args) -> int:
    """Static analysis over the port's tree and the zoo's programs
    (analysis/): AST convention lint + the program audit on `--device`,
    one report, exit 1 when any finding reaches the --fail-on severity."""
    from deeplearning4j_tpu_torch.analysis import (at_or_above,
                                                   audit_zoo_models,
                                                   lint_package, render_text,
                                                   to_report)

    findings, n_files = lint_package()
    n_programs = 0
    if not args.skip_programs:
        prog_findings, n_programs = audit_zoo_models(small=True,
                                                     device=args.device)
        findings = findings + prog_findings
    checked = {"files": n_files, "programs": n_programs}
    if args.format == "json":
        print(json.dumps(to_report(findings, checked)))
    else:
        print(render_text(findings, checked))
    return 1 if at_or_above(findings, args.fail_on) else 0


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' must be asked "
                        "for explicitly)")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--input", required=True,
                   help="mnist|iris|lfw|curves|cifar10[:n] | "
                        "csv:<path>[:label_col] | text:<path>[:seq_len] | "
                        "*.csv")
    p.add_argument("--model", default=None,
                   help="conf JSON (train) or checkpoint dir (test/predict)")
    p.add_argument("--label-column", dest="label_column", type=int,
                   default=-1)
    p.add_argument("--num-examples", dest="num_examples", type=int,
                   default=None)
    p.add_argument("--scale-01", dest="scale_01", action="store_true",
                   help="scale features into [-1, 1] by their max |value|")
    p.add_argument("--normalize", action="store_true",
                   help="zero-mean/unit-variance features")
    _add_compile_cache(p)
    _add_device(p)


def _add_compile_cache(p: argparse.ArgumentParser,
                       required: bool = False) -> None:
    p.add_argument("--compile-cache", dest="compile_cache", default=None,
                   required=required, metavar="DIR",
                   help="persistent store (int8 weights, prefix entries); "
                        "CUDA graphs are captured in each process")


def _add_precision(p: argparse.ArgumentParser) -> None:
    p.add_argument("--precision", choices=["f32", "bf16", "int8"],
                   default="f32",
                   help="serve-precision policy, set before any program is "
                        "captured (int8: its quantized weights are loaded "
                        "from, or calibrated into, --compile-cache)")


def _add_generate_flags(p: argparse.ArgumentParser) -> None:
    """`serve --generate` and its decode-table flags (the JAX package's
    names)."""
    p.add_argument("--generate", action="store_true",
                   help="also serve POST /v1/generate through a continuous-"
                        "batching decode table (programs captured first)")
    p.add_argument("--gen-slots", dest="gen_slots", type=int, default=None,
                   help="decode table width: streams per decode step "
                        "(default 4)")
    p.add_argument("--gen-max-seq", dest="gen_max_seq", type=int,
                   default=64,
                   help="KV-cache length per slot; prompt + generated "
                        "tokens must fit in it")
    p.add_argument("--gen-prompt-buckets", dest="gen_prompt_buckets",
                   default="8",
                   help="comma-separated prompt buckets (one captured "
                        "prefill each)")
    p.add_argument("--gen-max-pending", dest="gen_max_pending", type=int,
                   default=64,
                   help="queued generation streams bound; beyond it 503")
    p.add_argument("--gen-page-size", dest="gen_page_size", type=int,
                   default=None,
                   help="tokens a KV page; > 0 decodes through the paged "
                        "pool (memory scales with live tokens; default 0, "
                        "the dense table)")
    p.add_argument("--gen-pages", dest="gen_pages", type=int, default=0,
                   help="physical KV pages in the pool (0: every slot at "
                        "full --gen-max-seq; fewer overcommit, and streams "
                        "wait or are preempted and recomputed)")
    p.add_argument("--gen-prefix-cache", dest="gen_prefix_cache",
                   action="store_true",
                   help="keep prefills by prompt digest; a repeated prompt "
                        "skips its prefill, token-identical")
    p.add_argument("--gen-prefix-match", dest="gen_prefix_match",
                   choices=("exact", "longest"), default="exact",
                   help="prefix-cache matching: the exact prompt only, or "
                        "the longest cached prefix (the rest fed through "
                        "the decode table)")
    p.add_argument("--gen-draft", dest="gen_draft", default=None,
                   help="checkpoint dir of a small recurrent draft model "
                        "for speculative decoding (requires --gen-spec-k)")
    p.add_argument("--gen-spec-k", dest="gen_spec_k", type=int, default=0,
                   help="speculative chunk: the draft proposes spec_k - 1 "
                        "tokens, one verify step accepts the agreeing "
                        "prefix (the same tokens as without a draft)")
    p.add_argument("--gen-steps-per-dispatch",
                   dest="gen_steps_per_dispatch", type=int, default=None,
                   help="decode steps a dispatch, at most (K); the batcher "
                        "ramps 1 -> K while the slot set is stable and "
                        "pipelines the blocks; tokens are the same for any "
                        "K (default 1)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train a model and save a checkpoint")
    _add_common(t)
    t.add_argument("--output", required=True, help="checkpoint output dir")
    t.add_argument("--zoo", default=None,
                   help="train a zoo model instead of a conf JSON: "
                        "mlp|char_lstm|char_transformer[:k=v,...] (e.g. "
                        "mlp:hidden=512x512, char_lstm:layers=4,hidden=128)")
    t.add_argument("--runtime", choices=["local", "mesh"], default="local",
                   help="mesh: data-parallel training over the ranks of a "
                        "torch.distributed group (torchrun's, or this "
                        "process alone)")
    t.add_argument("--mesh", nargs="?", const="all", default=None,
                   metavar="SPEC",
                   help="batch=N (the 1-D layout) or batch=N,model=M "
                        "(tensor parallelism over N*M ranks); implies "
                        "--runtime mesh; bare --mesh or --mesh all is "
                        "every rank")
    t.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard the updater state over the ranks; "
                        "checkpoints gather it whole, so resume works on "
                        "any number of ranks")
    t.add_argument("--properties", default=None,
                   help="k=v[,k=v...]: epochs (default 1), batch (examples "
                        "per fit call; 0, the default, is the whole data), "
                        "checkpoint_every (batches between checkpoints with "
                        "--checkpoint-dir; default 10)")
    t.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None,
                   metavar="DIR",
                   help="crash-safe training: checkpoint params and the "
                        "batch cursor here; SIGTERM checkpoints and exits, "
                        "a rerun resumes")
    t.set_defaults(fn=cmd_train)

    te = sub.add_parser("test", help="evaluate a checkpoint")
    _add_common(te)
    te.add_argument("--batch", type=int, default=1024,
                    help="examples per forward (0 = one call)")
    te.set_defaults(fn=cmd_test)

    pr = sub.add_parser("predict", help="write predictions for a dataset")
    _add_common(pr)
    pr.add_argument("--output", default=None, help="predictions CSV path")
    pr.add_argument("--batch", type=int, default=1024,
                    help="examples per forward (0 = one call)")
    pr.set_defaults(fn=cmd_predict)
    g = sub.add_parser("generate",
                       help="generation from a checkpoint through the "
                            "cached KV-cache path (one prefill, then one "
                            "decode step a token)")
    g.add_argument("--model", required=True,
                   help="checkpoint dir of a generative model (char_lstm, "
                        "char_transformer)")
    _add_device(g)
    g.add_argument("--prompt", required=True,
                   help="comma-separated prompt token ids, e.g. 1,7,3")
    g.add_argument("--max-new-tokens", dest="max_new_tokens", type=int,
                   default=16,
                   help="tokens to generate (clamped so that prompt and "
                        "output fit --max-seq)")
    g.add_argument("--temperature", type=float, default=0.0,
                   help="0 decodes greedily; > 0 samples at it")
    g.add_argument("--seed", type=int, default=0,
                   help="PRNG seed of temperature sampling")
    g.add_argument("--max-seq", dest="gen_max_seq", type=int, default=64,
                   help="KV-cache length: prompt and generated tokens must "
                        "fit in it")
    g.add_argument("--timeout", type=float, default=120.0,
                   help="bound on the whole generation (seconds)")
    g.add_argument("--page-size", dest="gen_page_size", type=int,
                   default=0,
                   help="tokens a KV page; > 0 decodes through the paged "
                        "pool (the same tokens)")
    g.add_argument("--prefix-cache", dest="gen_prefix_cache",
                   action="store_true",
                   help="keep the prompt's prefill by digest")
    g.add_argument("--draft", dest="gen_draft", default=None,
                   help="draft-model checkpoint dir for speculative "
                        "decoding (requires --spec-k)")
    g.add_argument("--spec-k", dest="gen_spec_k", type=int, default=0,
                   help="speculative chunk size (>= 2; the draft proposes "
                        "spec_k - 1 tokens a verify step)")
    g.add_argument("--steps-per-dispatch", dest="gen_steps_per_dispatch",
                   type=int, default=None,
                   help="decode steps a dispatch, at most (the same tokens "
                        "for any value)")
    g.add_argument("--mesh", nargs="?", const="all", default=None,
                   metavar="SPEC",
                   help="decode over a mesh of ranks (one process a rank, "
                        "torchrun): bare --mesh or 'all' is the 1-D batch "
                        "mesh (generation on rank 0), batch=1,model=4 "
                        "splits heads and the K/V state over 4 ranks")
    _add_compile_cache(g)
    g.set_defaults(fn=cmd_generate)

    s = sub.add_parser("serve", help="micro-batching HTTP gateway: POST "
                                     "/v1/predict (and with --generate POST "
                                     "/v1/generate) + GET /v1/stats")
    s.add_argument("--model", required=True, help="checkpoint dir to serve")
    _add_device(s)
    s.add_argument("--mesh", nargs="?", const="all", default=None,
                   metavar="SPEC",
                   help="serve over a mesh of ranks (one process a rank, "
                        "torchrun; the HTTP front on rank 0): bare --mesh "
                        "or 'all' splits a batch's rows over every rank, "
                        "batch=2,model=2 also splits heads, FFN units and "
                        "the K/V state over the model axis")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=0,
                   help="0 picks an ephemeral port (printed in the startup "
                        "JSON)")
    s.add_argument("--max-delay-ms", dest="max_delay_ms", type=float,
                   default=None,
                   help="how long a request may wait for batch co-riders")
    s.add_argument("--max-pending", dest="max_pending", type=int,
                   default=1024,
                   help="queued-request bound; beyond it requests get 503")
    s.add_argument("--max-batch-rows", dest="max_batch_rows", type=int,
                   default=None, help="cap on coalesced rows per device call")
    s.add_argument("--shapes", default="64",
                   help="predict buckets captured before the socket opens: "
                        "batch sizes or full shapes, e.g. 64 or 2x512,8x512 "
                        "(an embedding net's are int32 ids); '' for none")
    s.add_argument("--no-batching", dest="no_batching", action="store_true",
                   help="answer each request with its own forward (no "
                        "coalescing)")
    s.add_argument("--default-deadline-ms", dest="default_deadline_ms",
                   type=float, default=None,
                   help="deadline of a request that names none (504 past "
                        "it)")
    s.add_argument("--drain-timeout", dest="drain_timeout", type=float,
                   default=10.0, metavar="SECONDS",
                   help="bound on the graceful drain at SIGTERM")
    s.add_argument("--request-timeout", dest="request_timeout", type=float,
                   default=30.0, metavar="SECONDS",
                   help="cap on how long one request may wait (504 past it)")
    _add_compile_cache(s)
    _add_precision(s)
    _add_generate_flags(s)
    s.add_argument("--replicas", type=int, default=0, metavar="N",
                   help="front N replica subprocesses (each its own "
                        "gateway and CUDA context, all sharing "
                        "--compile-cache) with the routing front end; 0 "
                        "(default) serves in-process with no router")
    s.add_argument("--min-replicas", dest="min_replicas", type=int,
                   default=None, metavar="N",
                   help="floor for the supervised fleet (default: "
                        "--replicas); scale-down and quarantine never "
                        "shrink below it")
    s.add_argument("--max-replicas", dest="max_replicas", type=int,
                   default=None, metavar="N",
                   help="ceiling for the supervised fleet (default: "
                        "--replicas); setting it above --min-replicas "
                        "enables the autoscaler")
    s.add_argument("--hedge", action="store_true",
                   help="hedged requests: a proxy attempt that outlives "
                        "the p95 of recent latencies is duplicated at a "
                        "second replica, first answer wins; hedges and "
                        "retries share the --retry-budget")
    s.add_argument("--retry-budget", dest="retry_budget", type=float,
                   default=0.1, metavar="RATIO",
                   help="extra attempts (retries + hedges) allowed as a "
                        "fraction of the trailing request window "
                        "(default 0.1)")
    s.add_argument("--slo-p99-ms", dest="slo_p99_ms", type=float,
                   default=500.0,
                   help="autoscaler latency objective: fleet p99 above "
                        "this is a scale-up signal")
    s.add_argument("--agent", action="append", default=None, metavar="URL",
                   help="multi-host: spawn replicas through a ReplicaAgent "
                        "at URL instead of forking locally (repeatable, "
                        "one per host); supervision becomes lease-based")
    s.add_argument("--agent-failover", dest="agent_failover", type=float,
                   default=10.0, metavar="SECONDS",
                   help="how long an agent may stay partitioned before "
                        "its replicas fail over to surviving agents")
    s.add_argument("--cache-from", dest="cache_from", action="append",
                   default=None, metavar="URL",
                   help="on a local store miss, fetch the entry from these "
                        "cachesync URLs (repeatable, tried in order) "
                        "before recomputing it; fetched entries are "
                        "checksum-validated and served from memory")
    s.set_defaults(fn=cmd_serve)

    tu = sub.add_parser(
        "tune",
        help="search the tunables registry's config space (flash tiles, "
             "batch targets, decode geometry) by measuring real captured "
             "programs and kernels; persist the winning table per (conf "
             "fingerprint, device kind) in the store")
    tu.add_argument("--model", required=True,
                    help="conf JSON or checkpoint dir to tune for")
    _add_device(tu)
    tu.add_argument("--compile-cache", dest="compile_cache", default=None,
                    metavar="DIR",
                    help="persistent store to keep the tuned table in (and "
                         "to inherit an existing one from: inherited tables "
                         "report fresh_tunes == 0)")
    tu.add_argument("--groups", default="attention,serve,decode",
                    help="comma-separated tunable groups to search")
    tu.add_argument("--rounds", type=int, default=3,
                    help="timed rounds per candidate (min-of-rounds)")
    tu.add_argument("--seed", type=int, default=0,
                    help="rng seed for measurement inputs (the search is "
                         "deterministic under a fixed seed)")
    tu.add_argument("--gen-max-seq", dest="gen_max_seq", type=int,
                    default=64,
                    help="KV-cache length for the decode-group sweep")
    tu.add_argument("--force", action="store_true",
                    help="re-search even when the store already holds a "
                         "valid table for this (fingerprint, device kind)")
    tu.set_defaults(fn=cmd_tune)

    ag = sub.add_parser(
        "agent",
        help="per-host replica agent: HTTP control plane (POST /a/spawn, "
             "POST /a/stop, GET /a/health, GET /a/replicas, GET "
             "/a/cache/{key}) that owns this host's replica subprocesses "
             "for a remote serve --agent supervisor")
    ag.add_argument("--host", default="127.0.0.1")
    ag.add_argument("--port", type=int, default=0,
                    help="0 picks an ephemeral port (printed in the startup "
                         "JSON)")
    ag.add_argument("--compile-cache", dest="compile_cache", default=None,
                    metavar="DIR",
                    help="this host's persistent store: every spawned "
                         "replica is pinned to it, and its checksummed "
                         "entries are served to cold peers over GET "
                         "/a/cache/{key}")
    ag.add_argument("--max-replicas", dest="max_replicas", type=int,
                    default=4, metavar="N",
                    help="capacity cap: spawns beyond it get 409 (default 4)")
    ag.add_argument("--drain-timeout", dest="drain_timeout", type=float,
                    default=10.0, metavar="SECONDS",
                    help="bound on each child's SIGTERM graceful drain at "
                         "agent shutdown")
    ag.set_defaults(fn=cmd_agent)

    w = sub.add_parser("warmup", help="fill a persistent store ahead of "
                                      "traffic: only its byte payloads "
                                      "last (--precision int8's weights); "
                                      "the shapes captured end with the "
                                      "process")
    w.add_argument("--model", required=True,
                   help="checkpoint dir (or conf JSON) to warm up")
    _add_device(w)
    _add_compile_cache(w, required=True)
    w.add_argument("--shapes", default="1024",
                   help="comma-separated batch sizes or full input shapes "
                        "('x'-separated dims): 256,1024 or 4x512")
    w.add_argument("--entries", default="output",
                   help="serve entry points to capture: "
                        "output,feed_forward,loss")
    w.add_argument("--train", action="store_true",
                   help="also capture the train step for each shape")
    w.add_argument("--mesh", nargs="?", const="all", default=None,
                   metavar="SPEC",
                   help="warm under a serving mesh (one process a rank, "
                        "torchrun), as `serve --mesh` with the same spec")
    _add_precision(w)
    _add_generate_flags(w)
    w.set_defaults(fn=cmd_warmup)

    an = sub.add_parser(
        "analyze",
        help="static analysis: lint the port's ASTs against repo "
             "conventions and audit the zoo models' programs, each run "
             "once under a recording dispatch mode (analysis/)")
    an.add_argument("--format", choices=["text", "json"], default="text",
                    help="report rendering (json emits the versioned "
                         "report schema tests assert on)")
    an.add_argument("--fail-on", dest="fail_on",
                    choices=["warn", "error"], default="error",
                    help="exit 1 when any finding reaches this severity "
                         "(default error)")
    an.add_argument("--skip-programs", dest="skip_programs",
                    action="store_true",
                    help="lint only: skip running + auditing the zoo "
                         "models' programs (fast pre-commit mode)")
    _add_device(an)
    an.set_defaults(fn=cmd_analyze)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
