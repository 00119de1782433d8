"""One rank of the port's tensor-, sequence-, pipeline- and expert-parallel
scenarios at world size 4.

    RANK=r WORLD_SIZE=4 python tests/torch_tp_worker.py WORKDIR

`tests/test_torch_tp_ranks.py` writes WORKDIR/scenarios.json and
WORKDIR/inputs.npz (confs, JAX's initial params, batches, attention and
MoE inputs), then starts one process per rank. Each rank joins a gloo
group through a file store in WORKDIR, runs every scenario on the CPU,
and rank 0 writes WORKDIR/out/<scenario>.npz:

- `megatron`: copy-to-, reduce-from- and gather-from-model in a
  two-layer MLP split over 4 ranks, values and gradients;
- `output/<mesh>`: the charTransformer's output under the model axis;
- `train/<name>`: a `DataParallelTrainer(plan=)` run over the batches,
  the params and updater gathered whole, and the per-batch scores;
- `ckpt`: a 2 x 2 run checkpointed (the sharded layout) after 2 of 4
  batches into WORKDIR/ck_tp, then resumed on 1 x 4 over all 4;
- `ring_*`, `ulysses_*`: each rank's sequence shard of the output and of
  the gradients of sum(o ** 2), gathered;
- `pipeline`: the 4-stage forward, grads and 5 SGD steps;
- `moe`: y, aux and the grads of mean(y ** 2) + 0.01 aux;
- `cli`: the CLI's `train --mesh batch=2,model=2` last line, its net
  started from JAX's initial params.

The process imports no JAX and nothing of the JAX package, and records
that it did not.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys


def main(workdir: str) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        network_output)
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves
    from deeplearning4j_tpu_torch.parallel import (data_parallel, expert,
                                                   pipeline, sequence)
    from deeplearning4j_tpu_torch.parallel.checkpoint import \
        params_from_numpy
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.parallel.plan import ShardPlan, plan_mesh

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
    plans = {}

    def plan_of(layout):
        if layout not in plans:
            b, m = (int(v) for v in layout.split("x"))
            plans[layout] = ShardPlan(mesh=plan_mesh(
                {"batch": b, "model": m}, device="cpu"))
        return plans[layout]

    def conf_of(name):
        return MultiLayerConfiguration.from_json(spec["confs"][name])

    def whole_params(name):
        layers = {}
        for key in inputs.files:
            parts = key.split("/")
            if parts[0] == "params" and parts[1] == name:
                layers.setdefault(int(parts[2]), {})[parts[3]] = inputs[key]
        return [layers.get(i, {}) for i in range(conf_of(name).n_layers)]

    def net_of(name):
        net = MultiLayerNetwork(conf_of(name), device="cpu")
        net.params = params_from_numpy(whole_params(name), "cpu")
        return net

    def write(name, arrays):
        if rank == 0:
            np.savez(os.path.join(out_dir, name.replace("/", "__")
                                  + ".npz"), **arrays)

    class Recorder:
        def __init__(self):
            self.scores = []

        def iteration_done(self, model, iteration, score):
            self.scores.append(float(score))

    def trees(trainer):
        params, updater, _ = trainer.gathered_state()
        out = {f"p/{i}": t.detach().numpy().copy()
               for i, t in enumerate(tree_leaves(params))}
        out.update({f"u/{i}": t.detach().numpy().copy()
                    for i, t in enumerate(tree_leaves(updater))})
        return out

    def batches_of(sc):
        return [(inputs[f"data/{sc['data']}/x{i}"],
                 inputs[f"data/{sc['data']}/y{i}"])
                for i in range(sc["n_batches"])]

    # -- the Megatron collectives over a model axis of 4 --------------------
    from deeplearning4j_tpu_torch.parallel import tensor

    m4 = plan_of("1x4").mesh
    tp4 = tensor.TensorParallel(m4.axis_group("model"), 4,
                                m4.coord("model"), {})
    x = torch.from_numpy(inputs["mega/x"]).requires_grad_()
    w1, w2 = (torch.from_numpy(inputs[f"mega/{n}"]) for n in ("W1", "W2"))
    cols = w1.shape[1] // 4
    mine = [w1[:, tp4.rank * cols:(tp4.rank + 1) * cols].clone()
            .requires_grad_(),
            w2[tp4.rank * cols:(tp4.rank + 1) * cols].clone()
            .requires_grad_()]
    h = torch.tanh(tp4.copy_to_model(x) @ mine[0])
    z = tp4.reduce_from_model(h @ mine[1])
    g = tp4.gather_from_model(h)
    ((z ** 2).sum() + (g ** 3).sum()).backward()
    grads = {}
    for name, part, dim in (("dW1", mine[0].grad, 1), ("dW2", mine[1].grad,
                                                        0)):
        buf = [torch.empty_like(part) for _ in range(4)]
        dist.all_gather(buf, part.contiguous())
        grads[name] = torch.cat(buf, dim=dim).numpy()
    write("megatron", dict(z=z.detach().numpy(), g=g.detach().numpy(),
                           dx=x.grad.numpy(), **grads))

    # -- the charTransformer under the model axis --------------------------
    for sc in spec["output"]:
        plan = plan_of(sc["layout"])
        tp = data_parallel.plan_tp(conf_of(sc["conf"]), plan)
        local = data_parallel.plan_params_from_numpy(
            whole_params(sc["conf"]), conf_of(sc["conf"]), plan, "cpu")
        with torch.no_grad():
            y = network_output(conf_of(sc["conf"]), local,
                               torch.from_numpy(inputs["output/x"]), tp=tp)
        write(f"output/{sc['layout']}", {"y": y.numpy()})

    for sc in spec["train"]:
        rec = Recorder()
        t = data_parallel.DataParallelTrainer(
            net_of(sc["conf"]), plan=plan_of(sc["layout"]),
            listeners=[rec], **sc["options"])
        t.fit(batches_of(sc), epochs=1)
        # the network holds the trained params whole after fit
        net_whole = all(a.shape == b.shape for a, b in zip(
            tree_leaves(t.net.params),
            tree_leaves(t.gathered_state()[0])))
        write(f"train/{sc['name']}", dict(
            trees(t), scores=np.asarray(rec.scores),
            net_params=np.concatenate([a.detach().reshape(-1).numpy()
                                       for a in tree_leaves(t.net.params)]),
            net_whole=np.bool_(net_whole)))

    # -- sharded checkpoints: 2 x 2 writes, 1 x 4 resumes ------------------
    sc = spec["ckpt"]
    batches = batches_of(sc)
    ck = os.path.join(workdir, "ck_tp")
    t = data_parallel.DataParallelTrainer(
        net_of(sc["conf"]), plan=plan_of("2x2"), zero1=True)
    t.fit(batches[:2], checkpoint_dir=ck, checkpoint_every_n_batches=1)
    written = trees(t)
    if rank == 0:
        shutil.copytree(ck, os.path.join(workdir, "ck_tp_2x2"))
    dist.barrier()
    rec = Recorder()
    t2 = data_parallel.DataParallelTrainer(
        net_of(sc["conf"]), plan=plan_of("1x4"), listeners=[rec])
    t2.fit(batches, checkpoint_dir=ck)
    write("ckpt", dict({f"w/{k}": v for k, v in written.items()},
                       **trees(t2), scores=np.asarray(rec.scores),
                       resumed=np.int64(t2.resumed_from_step)))

    # -- ring and Ulysses attention over S = 4 shards ----------------------
    sp = make_mesh({"sp": 4}, device="cpu")
    r = sp.coord("sp")
    for kind in ("ring", "ulysses"):
        for causal in (False, True):
            q, k, v = (torch.from_numpy(inputs[f"attn/{n}"]) for n in "qkv")
            s_loc = q.shape[1] // 4
            shard = [t[:, r * s_loc:(r + 1) * s_loc].clone().requires_grad_()
                     for t in (q, k, v)]
            fn = sequence.make_context_parallel_attention(
                sp, kind=kind, causal=causal)
            o = fn(*shard)
            (o ** 2).sum().backward()
            out = {}
            for name, part in [("o", o.detach())] + [
                    (f"d{n}", t.grad) for n, t in zip("qkv", shard)]:
                buf = [torch.empty_like(part) for _ in range(4)]
                dist.all_gather(buf, part.contiguous())
                out[name] = torch.cat(buf, dim=1).numpy()
            write(f"{kind}_{'causal' if causal else 'full'}", out)

    # -- the pipeline at 4 stages ------------------------------------------
    pp = make_mesh({"pp": 4}, device="cpu")
    s = pp.coord("pp")

    def stage(p, x):
        return torch.tanh(x @ p["W"] + p["b"])

    def my_stage():
        return {"W": torch.from_numpy(inputs["pipe/W"][s]).requires_grad_(),
                "b": torch.from_numpy(inputs["pipe/b"][s]).requires_grad_()}

    px, py = (torch.from_numpy(inputs[f"pipe/{n}"]) for n in ("x", "y"))
    p = my_stage()
    out = pipeline.pipeline_apply(stage, p, px, pp, axis="pp")
    ((out - py) ** 2).mean().backward()
    grads = {}
    for name in ("W", "b"):
        buf = [torch.empty_like(p[name]) for _ in range(4)]
        dist.all_gather(buf, p[name].grad.contiguous())
        grads[f"g{name}"] = torch.stack(buf).numpy()
    step = pipeline.make_pipeline_train_step(
        stage, lambda o, tgt: ((o - tgt) ** 2).mean(), pp, lr=0.3)
    params, losses = my_stage(), []
    tx = torch.from_numpy(inputs["pipe/tx"])
    for _ in range(5):
        params, loss = step(params, tx, 0.5 * tx)
        losses.append(float(loss))
    buf = [torch.empty_like(params["W"]) for _ in range(4)]
    dist.all_gather(buf, params["W"].contiguous())
    write("pipeline", dict(out=out.detach().numpy(), losses=np.asarray(
        losses), trained_W=torch.stack(buf).numpy(), **grads))

    # -- MoE at 4 shards ---------------------------------------------------
    ep = make_mesh({"ep": 4}, device="cpu")
    e = ep.coord("ep")
    x = torch.from_numpy(inputs["moe/x"])
    t_loc = x.shape[0] // 4
    n_exp = inputs["moe/router"].shape[1]
    e_loc = n_exp // 4
    mp = {"router": torch.from_numpy(inputs["moe/router"]).requires_grad_()}
    for name in ("W1", "b1", "W2", "b2"):
        mp[name] = torch.from_numpy(
            inputs[f"moe/{name}"][e * e_loc:(e + 1) * e_loc].copy()
        ).requires_grad_()
    y, aux = expert.moe_ffn(mp, x[e * t_loc:(e + 1) * t_loc], ep,
                            capacity_factor=float(n_exp))
    # this rank's part of mean(y ** 2) over every token, and the aux once
    ((y ** 2).sum() / (x.numel()) + 0.01 * aux).backward()
    res = {"aux": aux.detach().numpy(), "router_grad": mp["router"].grad}
    ys = [torch.empty_like(y) for _ in range(4)]
    dist.all_gather(ys, y.detach().contiguous())
    res["y"] = torch.cat(ys).numpy()
    for name in ("W1", "b1", "W2", "b2"):
        buf = [torch.empty_like(mp[name]) for _ in range(4)]
        dist.all_gather(buf, mp[name].grad.contiguous())
        res[f"g{name}"] = torch.cat(buf).numpy()
    res["router_grad"] = res["router_grad"].numpy()
    write("moe", res)

    # -- the CLI under 4 ranks ---------------------------------------------
    from deeplearning4j_tpu_torch.cli.driver import main as cli_main

    # the CLI's net starts from JAX's initial params
    real_init = MultiLayerNetwork.init

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        self.params = params_from_numpy(whole_params("cli"), self.device)
        return self

    MultiLayerNetwork.init = init
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(spec["cli"] + ["--output",
                                     os.path.join(workdir, "cli_out"),
                                     "--device", "cpu"])
    last = [line for line in buf.getvalue().splitlines()
            if line.startswith("{")][-1]
    write("cli", {"rc": np.int64(rc), "line": np.asarray(last)})

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "deeplearning4j_tpu"
                    or m.startswith("deeplearning4j_tpu."))
    np.savez(os.path.join(out_dir, f"imports_rank{rank}.npz"),
             leaked=np.asarray(leaked, dtype=str))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
