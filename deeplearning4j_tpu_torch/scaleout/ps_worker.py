"""Parameter-server worker process (`ApplicationWorker` analog).

The port of `deeplearning4j_tpu/scaleout/ps_worker.py`, the runnable
counterpart of `scaleout/param_server.py`: launched as

    python -m deeplearning4j_tpu_torch.scaleout.ps_worker \\
        --server http://host:port --worker-id w0 --conf conf.json

it registers via /startup, receives its data-split index, then runs BSP
rounds of {local fit -> POST /update -> poll /fetch} against the master —
the reference's YARN container loop (`ApplicationWorker` +
`ComputableWorker.compute`, `impl/multilayer/WorkerNode.java`) over the
HTTP protocol. In async mode it ships deltas and re-fetches the live
vector, so a slow peer gates no one.

The vector on the wire is `MultiLayerNetwork.params_flat()` in the JAX
package's flat order, so a port worker and a JAX worker can serve one
master. The network runs on `--device` (CUDA unless `cpu` is passed; the
JAX package's worker pins itself to the CPU). `main(argv)` runs in
process too, e.g. one thread a worker.
"""

from __future__ import annotations

import argparse
import sys
import time


def _build_net(conf_json: str, seed: int, device):
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = MultiLayerConfiguration.from_json(conf_json)
    return MultiLayerNetwork(conf, device=device, seed=seed).init()


def _load_shard(dataset: str, split_index: int, total_splits: int):
    """Deterministic shard of the named dataset for this worker —
    the analog of the YARN FileSplit in StartupConfiguration."""
    import numpy as np

    if dataset == "iris":
        from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher

        data = IrisDataFetcher().fetch(150).normalize_zero_mean_unit_variance()
        x = np.asarray(data.features)
        y = np.asarray(data.labels)
    else:
        raise SystemExit(f"unknown dataset {dataset!r}")
    return x[split_index::total_splits], y[split_index::total_splits]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ps_worker")
    p.add_argument("--server", required=True)
    p.add_argument("--worker-id", required=True)
    p.add_argument("--conf", required=True,
                   help="path to a MultiLayerConfiguration JSON")
    p.add_argument("--dataset", default="iris")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--timeout", type=float, default=60.0)
    p.add_argument("--slow", type=float, default=0.0,
                   help="sleep this many seconds per round (straggler "
                        "simulation for async-mode tests)")
    p.add_argument("--device", default=None,
                   help="torch device of the network (default: cuda)")
    args = p.parse_args(argv)

    import numpy as np

    from deeplearning4j_tpu_torch.scaleout.param_server import (
        ParameterServerWorker)

    client = ParameterServerWorker(args.server, args.worker_id,
                                   timeout_s=args.timeout)
    startup = client.startup()
    with open(args.conf) as f:
        net = _build_net(f.read(), seed=startup["split_index"],
                         device=args.device)
    x, y = _load_shard(args.dataset, startup["split_index"],
                       startup["total_splits"])

    def flat() -> np.ndarray:
        return net.params_flat().cpu().numpy()

    # round 0 params come from the master so every worker starts identical
    net.set_params_flat(client.fetch(0))
    t0 = time.monotonic()
    mode = startup.get("mode", "bsp")
    for r in range(args.rounds):
        if args.slow:
            time.sleep(args.slow)
        base = flat()                       # params this fit starts from
        net.fit(x, y)                       # local iterations (conf-driven)
        if mode == "async":
            # HogWild: ship the local delta, re-fetch the live vector —
            # no round gate, a slow peer never blocks this loop
            client.update_delta(flat() - base)
            client.progress(round=r, score=float(net.score(x, y)))
            net.set_params_flat(client.fetch(0))
        else:
            client.update(flat())
            client.progress(round=r, score=float(net.score(x, y)))
            net.set_params_flat(client.fetch(r + 1))  # polls til published
    client.metrics_report({"fit_seconds": time.monotonic() - t0,
                           "rounds": float(args.rounds)})
    client.complete()
    return 0


if __name__ == "__main__":
    sys.exit(main())
