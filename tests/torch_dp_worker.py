"""One rank of the port's data-parallel scenarios at world size > 1.

    RANK=r WORLD_SIZE=n python tests/torch_dp_worker.py WORKDIR

`tests/test_torch_dp_ranks.py` writes WORKDIR/scenarios.json (the confs as
JSON and, per scenario, its conf, trainer options, batches and epochs) and
WORKDIR/inputs.npz (the initial params of each conf and every batch), then
starts one process per rank. Each rank joins a gloo group through a file
store in WORKDIR (no port to race for), which `parallel.mesh.make_mesh`
then takes as its group, runs every scenario through the
port's `DataParallelTrainer` on the CPU, and rank 0 writes
WORKDIR/out/<scenario>.npz: the params and the whole updater state in tree
order, the score, and the per-batch scores. The `resume` scenario also
runs a checkpointed prefix, resumes it on the same ranks and records
whether that ends bitwise where an uninterrupted run ends, leaving the
prefix's checkpoint in WORKDIR/ck_elastic for a resume on another number
of ranks. The `sigterm_one_rank` scenario sends rank 1 alone a SIGTERM
mid-run and records, on every rank, whether it was interrupted, after how
many batches and with how many checkpoints. The process imports no JAX
and nothing of the JAX package, and records that it did not.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import sys


def _trees(trainer):
    from deeplearning4j_tpu_torch.optimize.tree import tree_leaves

    params, updater, _ = trainer.checkpoint_state()
    out = {f"p/{i}": t.detach().numpy().copy()
           for i, t in enumerate(tree_leaves(params))}
    out.update({f"u/{i}": t.detach().numpy().copy()
                for i, t in enumerate(tree_leaves(updater))})
    return out


class _Recorder:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(float(score))


class _KillAfter:
    """Sends this process a SIGTERM after its n-th batch."""

    def __init__(self, n):
        self.n, self.seen = n, 0

    def iteration_done(self, model, iteration, score):
        self.seen += 1
        if self.seen == self.n:
            os.kill(os.getpid(), signal.SIGTERM)


def main(workdir: str) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.checkpoint import \
        params_from_numpy
    from deeplearning4j_tpu_torch.parallel.data_parallel import \
        DataParallelTrainer
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.reliability import TrainingInterrupted

    with open(os.path.join(workdir, "scenarios.json")) as f:
        spec = json.load(f)
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    mesh = make_mesh(device="cpu")
    rank = mesh.rank
    out_dir = os.path.join(workdir, "out")
    os.makedirs(out_dir, exist_ok=True)

    def net_of(name):
        conf = MultiLayerConfiguration.from_json(spec["confs"][name])
        net = MultiLayerNetwork(conf, device="cpu")
        layers = {}
        for key in inputs.files:
            parts = key.split("/")
            if parts[0] == "params" and parts[1] == name:
                layers.setdefault(int(parts[2]), {})[parts[3]] = inputs[key]
        net.params = params_from_numpy(
            [layers.get(i, {}) for i in range(conf.n_layers)], "cpu")
        return net

    def batches_of(sc):
        return [(inputs[f"data/{sc['name']}/x{i}"],
                 inputs[f"data/{sc['name']}/y{i}"])
                for i in range(sc["n_batches"])]

    def trainer(sc):
        rec = _Recorder()
        t = DataParallelTrainer(net_of(sc["conf"]), mesh,
                                listeners=[rec], **sc["options"])
        return t, rec

    def write(name, arrays):
        if rank == 0:
            np.savez(os.path.join(out_dir, name + ".npz"), **arrays)

    for sc in spec["scenarios"]:
        batches = batches_of(sc)
        t, rec = trainer(sc)
        if sc["name"] == "sigterm_one_rank":
            # a SIGTERM to rank 1 alone, after its second batch: both ranks
            # must checkpoint at that cursor and raise
            if rank == 1:
                t.listeners.append(_KillAfter(2))
            try:
                t.fit(batches, epochs=sc["epochs"],
                      checkpoint_dir=os.path.join(workdir, "ck_sigterm"))
                interrupted = False
            except TrainingInterrupted:
                interrupted = True
            np.savez(os.path.join(out_dir, f"sigterm_rank{rank}.npz"),
                     interrupted=np.bool_(interrupted),
                     batches=np.int64(len(rec.scores)),
                     written=np.int64(t.checkpoints_written))
            continue
        if sc["name"] != "resume":
            score = t.fit(batches, epochs=sc["epochs"])
            write(sc["name"], dict(_trees(t), score=np.float32(score),
                                   scores=np.asarray(rec.scores)))
            continue
        # the uninterrupted run, a checkpointed prefix of 3 batches, and a
        # fresh trainer resuming it over the whole run
        t.fit(batches, epochs=sc["epochs"])
        ref = _trees(t)
        ck = os.path.join(workdir, "ck_same")
        t1, _ = trainer(sc)
        t1.fit(batches[:3], epochs=1, checkpoint_dir=ck,
               checkpoint_every_n_batches=1)
        if rank == 0:
            shutil.copytree(ck, os.path.join(workdir, "ck_elastic"))
        dist.barrier()
        t2, _ = trainer(sc)
        t2.fit(batches, epochs=sc["epochs"], checkpoint_dir=ck)
        got = _trees(t2)
        bitwise = all(np.array_equal(ref[k], got[k]) for k in ref)
        write("resume", dict(got, bitwise=np.bool_(bitwise),
                             resumed=np.int64(t2.resumed_from_step),
                             written=np.int64(t1.checkpoints_written)))
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
