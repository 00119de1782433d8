"""One rank of the port's serving-mesh scenarios at world size 4.

    RANK=r WORLD_SIZE=4 python tests/torch_serve_worker.py WORKDIR

`tests/test_torch_serve_mesh.py` writes WORKDIR/scenarios.json (the
confs, the layouts, the prompts) and WORKDIR/inputs.npz (JAX's initial
params, the served rows), then starts one process a rank. Each rank joins a
gloo group through a file store in WORKDIR and, for each layout
(batch x model), builds the network on the CPU, calls
`set_serve_mesh(spec=...)`; rank 0 then serves while the others `follow`,
and rank 0 writes WORKDIR/out/<layout>.npz and <layout>.json:

- `y`: the served output of the rows (ragged: the bucket rounds up to the
  batch axis);
- `dense`, `paged`: the greedy tokens of a `ContinuousBatcher` (the table
  and a paged pool), after `warmup_generate`;
- `spec`: the greedy tokens with a char-LSTM draft at spec_k 3;
- `prefix`, `kept_held`, `kept_left` (with `spec`): the greedy tokens of a
  batcher with the prefix cache, and rank 0's kept rows before and after
  that batcher is collected; every other rank writes the rows it still
  keeps at its end to WORKDIR/out/<layout>_kept_r<rank>.json;
- `keys`: every program key of the network's infer cache, as repr;
- the probe: one B = 1 prefill into a state of its own, whose K/V leaves
  every rank writes to WORKDIR/out/<layout>_state_r<rank>.npz (its own
  columns);
- `fault` (layouts that ask for it): rank 1 arms `serve.follower`, and
  rank 0 records the error its next call raises and the answer of the
  call after it.

A layout with "precision" sets that serve policy on every rank
(`set_serve_precision`, after `set_serve_mesh`); with "output_only" rank 0
serves the rows alone and writes `y` and `keys`, and the other ranks only
follow. With "requantize" (a params name of inputs.npz) as well, rank 0
then takes those params and sets the policy again alone, and records the
error of its next call (`stale`); then every rank takes them and sets it,
and rank 0 serves the rows again (`y2`).

The process imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time


def main(workdir: str) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves
    from deeplearning4j_tpu_torch.parallel.checkpoint import \
        params_from_numpy
    from deeplearning4j_tpu_torch.reliability import faults
    from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher

    with open(os.path.join(workdir, "scenarios.json")) as f:
        spec = json.load(f)
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    rank = dist.get_rank()
    out_dir = os.path.join(workdir, "out")
    os.makedirs(out_dir, exist_ok=True)

    def params_of(name, n_layers):
        layers = {}
        for key in inputs.files:
            parts = key.split("/")
            if parts[0] == "params" and parts[1] == name:
                layers.setdefault(int(parts[2]), {})[parts[3]] = inputs[key]
        return params_from_numpy(
            [layers.get(i, {}) for i in range(n_layers)], "cpu")

    def net_of(name):
        conf = MultiLayerConfiguration.from_json(spec["confs"][name])
        net = MultiLayerNetwork(conf, device="cpu")
        net.params = params_of(name, conf.n_layers)
        return net

    g = spec["generate"]

    def batcher(net, **options):
        net.warmup_generate(slots=2, max_seq=g["max_seq"],
                            prompt_buckets=(g["bucket"],), **{
                                k: v for k, v in options.items()
                                if k != "draft_net" or v is not None})
        return ContinuousBatcher(net, n_slots=2, max_seq=g["max_seq"],
                                 prompt_buckets=(g["bucket"],), **options)

    def run(cb):
        try:
            return list(cb.submit(g["prompt"], max_new_tokens=g["new"])
                        .tokens(timeout=120.0))
        finally:
            cb.stop()

    def tokens(net, **options):
        return run(batcher(net, **options))

    for sc in spec["layouts"]:
        name = sc["layout"]
        b, m = (int(v) for v in name.split("x"))
        net = net_of("tf")
        mesh = net.set_serve_mesh(spec=f"batch={b},model={m}")
        if sc.get("precision"):
            net.set_serve_precision(sc["precision"], measure=False)
        ic = net.infer_cache
        again = sc.get("requantize")
        if sc.get("output_only"):
            if rank == 0:
                x = torch.from_numpy(inputs["output/x"])
                arrays = {"y": net.output(x).numpy()}
                result = {"keys": sorted(repr(k) for k in ic._programs),
                          "policy": ic.policy}
                if again:
                    net.params = params_of(again, net.conf.n_layers)
                    net.set_serve_precision(sc["precision"], measure=False)
                    try:
                        net.output(x)
                        result["stale"] = None
                    except Exception as e:  # noqa: BLE001 — expected
                        result["stale"] = f"{type(e).__name__}: {e}"
                    net.stop_followers()
                    dist.barrier()
                    arrays["y2"] = net.output(x).numpy()
                np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)
                with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
                    json.dump(result, f)
                net.stop_followers()
            else:
                net.follow()
                if again:
                    net.params = params_of(again, net.conf.n_layers)
                    net.set_serve_precision(sc["precision"], measure=False)
                    dist.barrier()
                    net.follow()
            continue
        if rank != 0:
            net.follow()
            if sc.get("fault"):
                dist.barrier()
                if rank == 1:
                    faults.arm("serve.follower", nth=1)
                net.follow()
                faults.reset()
            with open(os.path.join(out_dir, f"{name}_kept_r{rank}.json"),
                      "w") as f:
                json.dump(len(ic._kept), f)
            with open(os.path.join(out_dir, f"{name}_probe.json")) as f:
                desc = tuple(tuple(v) if isinstance(v, list) else v
                             for v in json.load(f))
            state = ic._follower_states[desc]
            np.savez(os.path.join(out_dir, f"{name}_state_r{rank}.npz"),
                     **{f"{i}/{k}": t.numpy() for i, lay in enumerate(state)
                        for k, t in lay.items()})
            continue
        result = {"rank_of_mesh": mesh.rank}
        x = torch.from_numpy(inputs["output/x"])
        arrays = {"y": net.output(x).numpy()}
        result["dense"] = tokens(net)
        result["paged"] = tokens(net, page_size=g["page_size"],
                                 n_pages=g["n_pages"])
        if sc.get("spec"):
            draft = net_of("draft")
            result["spec"] = tokens(net, draft_net=draft, spec_k=3)
            cb = batcher(net, prefix_cache=True)
            result["prefix"] = run(cb)
            result["kept_held"] = len(ic._kept)
            del cb
            gc.collect()
            result["kept_left"] = len(ic._kept)
        # the probe: one prefill into a state of its own
        probe = ic.decode_state(net.conf, 1, g["max_seq"], "cpu", "probe")
        ic.reset_state(probe)
        prompt = np.zeros((1, g["bucket"]), np.int32)
        prompt[0, :len(g["prompt"])] = g["prompt"]
        ic.prefill(net.conf, net.params, probe, prompt,
                   np.asarray([len(g["prompt"])], np.int32),
                   np.zeros((1, 2), np.uint32), np.zeros((1,), np.float32))
        arrays.update({f"state/{i}/{k}": t.numpy()
                       for i, lay in enumerate(probe)
                       for k, t in lay.items()})
        with open(os.path.join(out_dir, f"{name}_probe.json"), "w") as f:
            json.dump(list(ic._descs[id(probe)][0]), f)
        result["keys"] = sorted(repr(k) for k in ic._programs)
        result["bytes"] = {
            "params": sum(t.numel() * t.element_size() for t in
                          tree_leaves(ic._local_params(net.conf,
                                                       net.params))),
            "state": sum(t.numel() * t.element_size()
                         for t in tree_leaves(probe))}
        net.stop_followers()
        if sc.get("fault"):
            dist.barrier()
            t0 = time.monotonic()
            try:
                net.output(x)
                result["fault"] = None
            except Exception as e:  # noqa: BLE001 — the expected error
                result["fault"] = f"{type(e).__name__}: {e}"
            result["fault_s"] = time.monotonic() - t0
            arrays["y_after_fault"] = net.output(x).numpy()
            net.stop_followers()
        np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(result, f)
    dist.barrier()
    with open(os.path.join(out_dir, f"imports_r{rank}.json"), "w") as f:
        json.dump(sorted(m for m in sys.modules
                         if m == "jax" or m.startswith(("jax.",
                                                        "deeplearning4j_tpu."))
                         or m == "deeplearning4j_tpu"), f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
