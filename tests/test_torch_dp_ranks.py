"""The port's data-parallel trainer at world size 2 vs the JAX package's on
a mesh of 2.

One spawn of two gloo ranks (`tests/torch_dp_worker.py`, which imports
neither JAX nor `deeplearning4j_tpu`) runs every scenario on the same
numpy-seeded batches and JAX's initial params; JAX's side runs here on two
of the conftest's virtual CPU devices. Each scenario is a case of one test
over a module-scoped fixture. Tolerances: rtol 2e-4, atol 2e-5 on params
and updater state (the JAX package's dp-vs-single-device tolerances,
`tests/test_parallel.py:86-101`), 1e-5 on scores, bitwise where the port
is held to itself.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn import conf as jax_conf  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet  # noqa: E402,E501
from deeplearning4j_tpu.parallel.data_parallel import \
    DataParallelTrainer as JaxTrainer  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel.checkpoint import params_from_numpy  # noqa: E402,E501
from deeplearning4j_tpu_torch.parallel.data_parallel import \
    DataParallelTrainer  # noqa: E402
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dp_worker.py")
RTOL, ATOL = 2e-4, 2e-5


def _bn_conf():
    jc = jax_conf
    opt = jc.OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT
    confs = (jc.NeuralNetConfiguration(n_in=6, n_out=6, activation="tanh",
                                       lr=0.1, optimization_algo=opt),
             jc.NeuralNetConfiguration(layer_type=jc.LayerType.BATCH_NORM,
                                       n_in=6, n_out=6, lr=0.1,
                                       optimization_algo=opt),
             jc.NeuralNetConfiguration(layer_type=jc.LayerType.OUTPUT,
                                       n_in=6, n_out=3, lr=0.1,
                                       optimization_algo=opt))
    return jc.MultiLayerConfiguration(confs=confs)


def _adam(conf):
    return conf.replace(confs=tuple(c.replace(updater="adam", lr=0.01,
                                              fused_updater=True)
                                    for c in conf.confs))


CONFS = {
    "mlp": lambda: jax_zoo.mlp(12, [16], 3),
    "mlp_adam": lambda: _adam(jax_zoo.mlp(12, [16], 3)),
    "lstm": lambda: jax_zoo.char_lstm(10, hidden=8, sparse_labels=True,
                                      embed=8),
    "bn": _bn_conf,
}

# name, conf, trainer options, batch sizes, epochs
SCENARIOS = [
    ("sync", "mlp_adam", {}, [8, 8], 1),
    ("masked_tail_7", "mlp", {}, [7], 1),
    ("masked_tail_1", "mlp", {}, [1], 1),
    ("masked_averaging", "mlp", {"mode": "averaging", "local_steps": 2},
     [7, 8], 1),
    ("zero1", "mlp_adam", {"zero1": True}, [8, 8], 1),
    ("zero1_masked", "mlp_adam", {"zero1": True}, [7], 1),
    ("sequence_label_rows", "lstm", {}, [3, 4], 1),
    ("batchnorm_ema", "bn", {}, [16, 16], 1),
    ("resume", "mlp", {}, [8, 8, 8, 8, 8, 8], 2),
    ("sigterm_one_rank", "mlp_adam", {"zero1": True}, [8, 8, 8, 8, 8], 1),
]
#: scenarios of the port alone
PORT_ONLY = ("resume", "sigterm_one_rank")
JAX_CASES = [s[0] for s in SCENARIOS if s[0] not in PORT_ONLY]
#: scenarios trained on another scenario's batches
SAME_DATA = {"zero1": "sync"}


def _batch(conf_name, rows, rng):
    if conf_name == "lstm":
        ids = rng.randint(0, 10, (rows, 6))
        return (ids[:, :-1].astype(np.int32),
                ids[:, 1:].reshape(-1).astype(np.int32))
    if conf_name == "bn":
        # unsaturated tanh units: a feature of ~0 variance in a shard
        # amplifies rounding through BatchNorm's 1/sigma
        x = rng.randn(rows, 6).astype(np.float32) * 0.5
    else:
        x = (rng.rand(rows, 12) * 3 + 1).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.randint(0, 3, rows)]


def _jax_trainer(conf, params, n, **options):
    net = JaxNet(conf)
    net.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    return JaxTrainer(net, jax_mesh({"dp": n}, devices=jax.devices()[:n]),
                      **options)


class _Recorder:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(float(score))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the two ranks, run JAX's side of every scenario while they
    work, and collect both."""
    work = tmp_path_factory.mktemp("dp_ranks")
    rng = np.random.RandomState(0)
    confs = {name: make() for name, make in CONFS.items()}
    params = {name: jax.device_get(JaxNet(c).init().params)
              for name, c in confs.items()}
    arrays, batches, spec = {}, {}, []
    for name, conf_name, options, sizes, epochs in SCENARIOS:
        batches[name] = (batches[SAME_DATA[name]] if name in SAME_DATA
                         else [_batch(conf_name, b, rng) for b in sizes])
        for i, (x, y) in enumerate(batches[name]):
            arrays[f"data/{name}/x{i}"], arrays[f"data/{name}/y{i}"] = x, y
        spec.append({"name": name, "conf": conf_name, "options": options,
                     "n_batches": len(sizes), "epochs": epochs})
    for name, tree in params.items():
        for i, layer in enumerate(tree):
            for k, a in layer.items():
                arrays[f"params/{name}/{i}/{k}"] = np.asarray(a)
    np.savez(work / "inputs.npz", **arrays)
    with open(work / "scenarios.json", "w") as f:
        json.dump({"confs": {k: c.to_json() for k, c in confs.items()},
                   "scenarios": spec}, f)
    env = dict(os.environ, WORLD_SIZE="2", OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(work)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]

    jax_runs = {}
    for name, conf_name, options, sizes, epochs in SCENARIOS:
        if name in PORT_ONLY:
            continue
        rec = _Recorder()
        t = _jax_trainer(confs[conf_name], params[conf_name], 2, **options)
        t.listeners = [rec]
        t.fit(batches[name], epochs=epochs)
        jax_runs[name] = {"params": jax.tree_util.tree_leaves(
            jax.device_get(t.state.params)),
            "updater": jax.tree_util.tree_leaves(
                jax.device_get(t.state.updater)),
            "scores": rec.scores}
    # JAX's elastic run: 3 batches checkpointed on 2 devices, resumed on 1
    ck = str(work / "jax_ck")
    resume = next(s for s in SCENARIOS if s[0] == "resume")
    _jax_trainer(confs["mlp"], params["mlp"], 2).fit(
        batches["resume"][:3], epochs=1, checkpoint_dir=ck,
        checkpoint_every_n_batches=1)
    rec = _Recorder()
    t = _jax_trainer(confs["mlp"], params["mlp"], 1)
    t.listeners = [rec]
    t.fit(batches["resume"], epochs=resume[4], checkpoint_dir=ck)
    jax_runs["elastic"] = {"params": jax.tree_util.tree_leaves(
        jax.device_get(t.state.params)), "scores": rec.scores,
        "resumed": t.resumed_from_step}

    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    port = {f[:-4]: dict(np.load(work / "out" / f))
            for f in os.listdir(work / "out")}
    return {"work": work, "port": port, "jax": jax_runs, "confs": confs,
            "params": params, "batches": batches}


def _leaves(run, prefix):
    return [run[f"{prefix}/{i}"] for i in range(
        sum(1 for k in run if k.startswith(prefix + "/")))]


@pytest.mark.parametrize("name", JAX_CASES)
def test_two_ranks_train_as_jax_on_a_mesh_of_two(runs, name):
    got, want = runs["port"][name], runs["jax"][name]
    for a, b in zip(_leaves(got, "p"), want["params"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    # the updater state, gathered whole under ZeRO-1
    assert len(_leaves(got, "u")) == len(want["updater"])
    for a, b in zip(_leaves(got, "u"), want["updater"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                               atol=1e-5)
    if name == "masked_tail_1":
        # rank 1 held pad rows only, and the step still trained
        first = runs["params"]["mlp"][0]["W"]
        assert not np.allclose(_leaves(got, "p")[0], first)


def test_zero1_equals_plain_dp_on_two_ranks(runs):
    """ZeRO-1's chunked updater gives the sync step's params (the JAX
    package's own zero1-vs-dp tolerance, 3e-5 / 3e-6)."""
    z, s = runs["port"]["zero1"], runs["port"]["sync"]
    for a, b in zip(_leaves(z, "p"), _leaves(s, "p")):
        np.testing.assert_allclose(a, b, rtol=3e-5, atol=3e-6)
    for a, b in zip(_leaves(z, "u"), _leaves(s, "u")):
        np.testing.assert_allclose(a, b, rtol=3e-5, atol=3e-6)


def test_batchnorm_ema_takes_the_global_moments(runs):
    """The sync step's EMA is advanced from the moments summed over both
    ranks: its mean lands on the global batch's mean of the BatchNorm
    input, as JAX's psum puts it."""
    got = runs["port"]["batchnorm_ema"]
    names = sorted(runs["params"]["bn"][1])
    offset = len(runs["params"]["bn"][0])
    ema = {k: _leaves(got, "p")[offset + i] for i, k in enumerate(names)}
    want = runs["jax"]["batchnorm_ema"]["params"]
    for i, k in enumerate(names):
        np.testing.assert_allclose(ema[k], np.asarray(want[offset + i]),
                                   rtol=RTOL, atol=ATOL)
    assert float(ema["ema_w"]) > 0


def test_same_topology_resume_is_bitwise(runs):
    got = runs["port"]["resume"]
    assert int(got["written"]) >= 3
    assert int(got["resumed"]) == 3
    assert bool(got["bitwise"])


def test_checkpoint_of_two_ranks_resumes_on_one_as_jax(runs):
    """JAX's N -> M run (tests/test_elastic_resume.py:122-150): a
    checkpoint written by 2 ranks resumes on 1 and ends where JAX's run
    written on 2 devices and resumed on 1 ends."""
    want = runs["jax"]["elastic"]
    conf = MultiLayerConfiguration.from_json(runs["confs"]["mlp"].to_json())
    net = MultiLayerNetwork(conf, device="cpu")
    net.params = params_from_numpy(runs["params"]["mlp"], "cpu")
    rec = _Recorder()
    t = DataParallelTrainer(net, make_mesh({"dp": 1}, device="cpu"),
                            listeners=[rec])
    t.fit(runs["batches"]["resume"], epochs=2,
          checkpoint_dir=str(runs["work"] / "ck_elastic"))
    assert t.resumed_from_step == want["resumed"] == 3
    np.testing.assert_allclose(rec.scores, want["scores"], rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(tree_leaves(t.state.params), want["params"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("rank", [0, 1])
def test_sigterm_to_one_rank_stops_both_at_one_cursor(runs, rank):
    """A SIGTERM that reaches rank 1 alone, after its second batch, stops
    both ranks there (the flag is agreed across ranks): each checkpoints
    once, ZeRO-1's updater gathered, and raises; the checkpoint's cursor
    is 2."""
    from deeplearning4j_tpu_torch.parallel import checkpoint

    got = runs["port"][f"sigterm_rank{rank}"]
    assert bool(got["interrupted"])
    assert int(got["batches"]) == 2
    assert int(got["written"]) == 1
    _, _, meta = checkpoint.load_resilient(
        str(runs["work"] / "ck_sigterm"))
    assert meta["data_cursor"]["batches_done"] == 2


@pytest.mark.parametrize("rank", [0, 1])
def test_ranks_import_neither_jax_nor_the_jax_package(runs, rank):
    assert list(runs["port"][f"imports_rank{rank}"]["leaked"]) == []
