"""VGG-CIFAR10's first steps at a given lr, in the JAX package and in the
port, on the CPU, from the same initial draw and the same batches.

    python vgg_lr_witness.py [--lr 0.05] [--steps 8] [--seed 0]
                             [--dtype bfloat16|float32] [--batch 512]

`chip_smoke.py`'s `conv_vgg` phase trains `vgg_cifar10(width=64)` with
bf16 compute (bench.py's `_mixed`) at batch 512 on the CIFAR-10 stand-in.
This script runs the first `--steps` of that recipe twice, each side in a
process of its own (the port's side imports no JAX): the score of each
batch before its `fit` step, then the score of the first batch at the end.
Both nets start from `MultiLayerNetwork(conf, seed=seed).init()`, whose
params are the same threefry draw in both packages. It prints one JSON
line a side and one with the largest gap between the two trajectories.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _data(fetchers, n):
    import numpy as np

    ds = fetchers.Cifar10DataFetcher().fetch(n)
    return (np.ascontiguousarray(ds.features, np.float32),
            np.ascontiguousarray(ds.labels, np.float32))


def _trajectory(net, x, y, args):
    scores, t0 = [], time.perf_counter()
    for i in range(args.steps):
        xb = x[i * args.batch:(i + 1) * args.batch]
        yb = y[i * args.batch:(i + 1) * args.batch]
        scores.append(float(net.score(xb, yb)))
        net.fit(xb, yb)
    scores.append(float(net.score(x[:args.batch], y[:args.batch])))
    return {"scores": scores, "seconds": time.perf_counter() - t0}


def side_jax(args):
    from deeplearning4j_tpu.datasets import fetchers
    from deeplearning4j_tpu.models.zoo import vgg_cifar10
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork

    conf = vgg_cifar10(width=args.width, lr=args.lr)
    if args.dtype != "float32":
        conf = conf.replace(confs=tuple(c.replace(compute_dtype=args.dtype)
                                        for c in conf.confs))
    x, y = _data(fetchers, args.steps * args.batch)
    net = MultiLayerNetwork(conf, seed=args.seed).init()
    return _trajectory(net, x, y, args)


def side_port(args):
    import torch

    from deeplearning4j_tpu_torch.datasets import fetchers
    from deeplearning4j_tpu_torch.models.zoo import vgg_cifar10
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    torch.set_num_threads(args.threads)
    conf = vgg_cifar10(width=args.width, lr=args.lr)
    if args.dtype != "float32":
        conf = conf.with_compute_dtype(args.dtype)
    x, y = _data(fetchers, args.steps * args.batch)
    net = MultiLayerNetwork(conf, device="cpu", seed=args.seed).init()
    out = _trajectory(net, x, y, args)
    out["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                              for m in sys.modules)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--side", choices=("jax", "port"))
    args = p.parse_args(argv)
    if args.side:
        run = side_jax if args.side == "jax" else side_port
        print(json.dumps({"side": args.side, **run(args)}))
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS=str(args.threads),
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=true "
                         f"intra_op_parallelism_threads={args.threads}")
    sides = {}
    for side in ("jax", "port"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--side", side]
            + [a for a in (argv if argv is not None else sys.argv[1:])],
            env=env, cwd=here, check=True, stdout=subprocess.PIPE,
            text=True).stdout
        sides[side] = json.loads(out.strip().splitlines()[-1])
        print(json.dumps(sides[side]), flush=True)
    gaps = [abs(a - b) for a, b in zip(sides["jax"]["scores"],
                                       sides["port"]["scores"])]
    print(json.dumps({"lr": args.lr, "dtype": args.dtype, "seed": args.seed,
                      "max_score_gap": max(gaps),
                      "jax_max_first": max(sides["jax"]["scores"][:-1]),
                      "port_max_first": max(sides["port"]["scores"][:-1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
