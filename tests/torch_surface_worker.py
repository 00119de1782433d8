"""One rank of the port's serving plan at 1 x 2 (batch x model), for
`tests/test_torch_surface_api.py`.

    RANK=r WORLD_SIZE=2 python tests/torch_surface_worker.py WORKDIR

The test writes WORKDIR/conf.json (a charTransformer conf) and
WORKDIR/inputs.npz (JAX's initial params under "params/<layer>/<name>",
the served rows under "x"). Each rank joins a gloo group through a file
store in WORKDIR, builds the network on the CPU and sets the serving mesh
"batch=1,model=2"; rank 0 serves the rows while rank 1 follows, then both
write the checkpoint of their shards with `save_sharded_async` into
WORKDIR/ckpt and wait for it (`join_async`). Rank 0 writes WORKDIR/out.json:
the infer cache's `program_memory()` rows (keys as repr) and its program
count before and after `clear()`.

The process imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import sys


def main(workdir: str) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import checkpoint

    with open(os.path.join(workdir, "conf.json")) as f:
        conf = MultiLayerConfiguration.from_json(f.read())
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    rank = dist.get_rank()
    layers = [{} for _ in range(conf.n_layers)]
    for key in inputs.files:
        parts = key.split("/")
        if parts[0] == "params":
            layers[int(parts[1])][parts[2]] = inputs[key]
    net = MultiLayerNetwork(conf, device="cpu")
    net.params = checkpoint.params_from_numpy(layers, "cpu")
    net.set_serve_mesh(spec="batch=1,model=2")
    ic = net.infer_cache
    result = {}
    if rank == 0:
        net.output(torch.from_numpy(inputs["x"]))
        result["rows"] = [dict(r, key=repr(r["key"]))
                          for r in ic.program_memory()]
        net.stop_followers()
    else:
        net.follow()
    tp = ic._tp(net.conf)
    checkpoint.save_sharded_async(
        os.path.join(workdir, "ckpt"), ic._local_params(net.conf, net.params),
        conf=net.conf, step=3, tp=tp)
    checkpoint.join_async()
    dist.barrier()
    if rank == 0:
        result["programs_before_clear"] = len(ic)
        ic.clear()
        result["programs_after_clear"] = len(ic)
        result["rows_after_clear"] = len(ic.program_memory())
        result["imports"] = sorted(
            m for m in sys.modules if m == "jax" or m.startswith("jax.")
            or m == "deeplearning4j_tpu"
            or m.startswith("deeplearning4j_tpu."))
        with open(os.path.join(workdir, "out.json"), "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
