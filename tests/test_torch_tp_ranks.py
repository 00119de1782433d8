"""The port's tensor, sequence, pipeline and expert parallelism at world
size 4 vs the JAX package on a mesh of 4.

One spawn of four gloo ranks (`tests/torch_tp_worker.py`, which imports
neither JAX nor `deeplearning4j_tpu`) runs every scenario on numpy-seeded
inputs and JAX's initial params; JAX's side runs here on four of the
conftest's virtual CPU devices while the ranks work. Each scenario is a
case of one parametrised test over the module-scoped fixture.

Tolerances: the charTransformer's output rtol 1e-5, atol 1e-6 (against
JAX on one device); trained params and updater state rtol 2e-4, atol
2e-5 and scores 1e-5 (the JAX package's dp-vs-single-device tolerances,
`tests/test_parallel.py:86-101`); ring and Ulysses attention 2e-5 on
outputs and 1e-3 on grads, the pipeline 1e-5 forward and 1e-4 / 1e-5 on
grads, MoE 2e-4 on y, 1e-5 on aux and 1e-4 / 1e-6 on grads (JAX's own,
`tests/test_sequence_parallel.py`, `test_pipeline.py`,
`test_expert_parallel.py`); bitwise where JAX reads the port's
checkpoint.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.cli.driver import main as jax_main  # noqa: E402
from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet, network_output as jax_output)
from deeplearning4j_tpu.parallel import checkpoint as jax_ckpt  # noqa: E402
from deeplearning4j_tpu.parallel.data_parallel import \
    DataParallelTrainer as JaxTrainer  # noqa: E402
from deeplearning4j_tpu.parallel.expert import (  # noqa: E402
    init_moe_params, moe_ffn_dense)
from deeplearning4j_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402,E501
from deeplearning4j_tpu.parallel.pipeline import (  # noqa: E402
    make_pipeline_train_step, pipeline_apply)
from deeplearning4j_tpu.parallel.plan import (  # noqa: E402
    ShardPlan as JaxPlan, plan_mesh as jax_plan_mesh)
from deeplearning4j_tpu.parallel.sequence import full_attention  # noqa: E402,E501
from deeplearning4j_tpu_torch.cli.driver import main  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel.checkpoint import params_from_numpy  # noqa: E402,E501
from deeplearning4j_tpu_torch.parallel.data_parallel import \
    DataParallelTrainer  # noqa: E402
from deeplearning4j_tpu_torch.parallel.plan import ShardPlan, plan_mesh  # noqa: E402,E501

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_tp_worker.py")
RTOL, ATOL = 2e-4, 2e-5
VOCAB, SEQ = 11, 8


def _tf():
    """SGD with momentum: the key bias's gradient is zero in exact
    arithmetic (a softmax row is shift-invariant), so Adam and AdaGrad,
    which divide a gradient by its own size, step it by ±lr on rounding
    noise in both packages alike, and no two summation orders agree
    there."""
    return jax_zoo.char_transformer(VOCAB, d_model=32, n_blocks=2,
                                    n_heads=4, max_seq_len=SEQ, lr=0.1,
                                    updater="sgd", sparse_labels=True)


def _tf_reg():
    """Dropout on every layer, a global-norm clip and L2."""
    conf = _tf()
    confs = [c.replace(dropout=0.1) for c in conf.confs]
    confs[-1] = confs[-1].replace(gradient_clip_norm=0.05,
                                  use_regularization=True, l2=1e-3)
    return conf.replace(confs=tuple(confs))


def _cli_conf():
    """The JAX CLI's `--zoo mlp:hidden=8` on Iris (its lr 0.05)."""
    return jax_zoo.mlp(n_in=4, hidden=[8], n_out=3, lr=0.05)


CONFS = {"tf": _tf, "tf_reg": _tf_reg, "cli": _cli_conf}

# name, conf, layout (batch x model), trainer options, batch sizes
TRAIN = [
    ("tf_2x2", "tf", "2x2", {}, [8, 8]),
    ("tf_1x4", "tf", "1x4", {}, [8, 8]),
    # a 7-row tail pads to 8 over the batch axis of 2
    ("tf_reg_zero1_masked_2x2", "tf_reg", "2x2", {"zero1": True}, [8, 7]),
    ("tf_reg_zero1_1x4", "tf_reg", "1x4", {"zero1": True}, [8, 6]),
    # a 6-row tail pads to 8 over the batch axis of 4
    ("tf_reg_zero1_masked_4x1", "tf_reg", "4x1", {"zero1": True}, [8, 6]),
]
CKPT_BATCHES = 4
CLI = ["train", "--input", "iris:150", "--zoo", "mlp:hidden=8",
       "--normalize", "--properties", "epochs=2,batch=16"]
B, S, H, D = 2, 32, 4, 8
T_MOE, D_MOE, H_MOE, E_MOE = 64, 8, 16, 8
PIPE_D = 16


def _batch(rows, rng):
    ids = rng.randint(0, VOCAB, (rows, SEQ + 1))
    return (ids[:, :-1].astype(np.int32),
            ids[:, 1:].reshape(-1).astype(np.int32))


def _jax_plan(layout):
    b, m = (int(v) for v in layout.split("x"))
    return JaxPlan(mesh=jax_plan_mesh({"batch": b, "model": m},
                                      devices=jax.devices()[:b * m]))


def _jax_trainer(conf, params, layout, **options):
    net = JaxNet(conf)
    net.params = jax.tree_util.tree_map(jnp.asarray, params)
    return JaxTrainer(net, plan=_jax_plan(layout), **options)


class _Recorder:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(float(score))


def _stage(params, x):
    return jnp.tanh(x @ params["W"] + params["b"])


def _jax_pipeline(arrays):
    mesh = jax_mesh({"pp": 4}, devices=jax.devices()[:4])
    params = {"W": jnp.asarray(arrays["pipe/W"]),
              "b": jnp.asarray(arrays["pipe/b"])}
    x, y = jnp.asarray(arrays["pipe/x"]), jnp.asarray(arrays["pipe/y"])
    out = pipeline_apply(_stage, params, x, mesh, axis="pp")
    grads = jax.grad(lambda p: jnp.mean(
        (pipeline_apply(_stage, p, x, mesh) - y) ** 2))(params)
    step = make_pipeline_train_step(
        _stage, lambda o, tgt: jnp.mean((o - tgt) ** 2), mesh, lr=0.3)
    tx, losses = jnp.asarray(arrays["pipe/tx"]), []
    p = params
    for _ in range(5):
        p, loss = step(p, tx, 0.5 * tx)
        losses.append(float(loss))
    return {"out": np.asarray(out), "gW": np.asarray(grads["W"]),
            "gb": np.asarray(grads["b"]), "losses": np.asarray(losses),
            "trained_W": np.asarray(p["W"])}


def _jax_moe(params, x):
    def loss(p):
        y, aux = moe_ffn_dense(p, x, capacity_factor=float(E_MOE))
        return jnp.mean(y ** 2) + 0.01 * aux

    y, aux = moe_ffn_dense(params, x, capacity_factor=float(E_MOE))
    grads = jax.grad(loss)(params)
    return {"y": np.asarray(y), "aux": np.asarray(aux),
            **{f"g{k}": np.asarray(grads[k])
               for k in ("W1", "b1", "W2", "b2")},
            "router_grad": np.asarray(grads["router"])}


def _jax_megatron(arrays):
    """The worker's split MLP, whole: z = tanh(x W1) W2, g = tanh(x W1),
    and the gradients of sum(z ** 2) + sum(g ** 3)."""
    def parts(x, w1, w2):
        h = jnp.tanh(x @ w1)
        return h @ w2, h

    def loss(x, w1, w2):
        z, g = parts(x, w1, w2)
        return jnp.sum(z ** 2) + jnp.sum(g ** 3)

    args = [jnp.asarray(arrays[f"mega/{n}"]) for n in ("x", "W1", "W2")]
    z, g = parts(*args)
    dx, dw1, dw2 = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return {"z": np.asarray(z), "g": np.asarray(g), "dx": np.asarray(dx),
            "dW1": np.asarray(dw1), "dW2": np.asarray(dw2)}


def _jax_attention(arrays, causal):
    q, k, v = (jnp.asarray(arrays[f"attn/{n}"]) for n in "qkv")
    o = full_attention(q, k, v, causal=causal)
    grads = jax.grad(lambda q, k, v: jnp.sum(
        full_attention(q, k, v, causal=causal) ** 2), argnums=(0, 1, 2))(
        q, k, v)
    return {"o": np.asarray(o),
            **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four ranks, run JAX's side of every scenario while they
    work, and collect both."""
    work = tmp_path_factory.mktemp("tp_ranks")
    rng = np.random.RandomState(0)
    confs = {name: make() for name, make in CONFS.items()}
    params = {name: jax.device_get(JaxNet(c).init().params)
              for name, c in confs.items()}
    arrays, batches = {}, {}
    for name, _, _, _, sizes in TRAIN:
        batches[name] = [_batch(b, rng) for b in sizes]
    batches["ckpt"] = [_batch(8, rng) for _ in range(CKPT_BATCHES)]
    for name, bs in batches.items():
        for i, (x, y) in enumerate(bs):
            arrays[f"data/{name}/x{i}"], arrays[f"data/{name}/y{i}"] = x, y
    for name, tree in params.items():
        for i, layer in enumerate(tree):
            for k, a in layer.items():
                arrays[f"params/{name}/{i}/{k}"] = np.asarray(a)
    arrays["output/x"] = _batch(4, rng)[0]
    arrays["mega/x"] = rng.randn(5, 6).astype(np.float32)
    arrays["mega/W1"] = rng.randn(6, 8).astype(np.float32)
    arrays["mega/W2"] = rng.randn(8, 3).astype(np.float32)
    for n in "qkv":
        arrays[f"attn/{n}"] = rng.randn(B, S, H, D).astype(np.float32)
    arrays["pipe/W"] = (rng.randn(4, PIPE_D, PIPE_D) * 0.3).astype(
        np.float32)
    arrays["pipe/b"] = (rng.randn(4, PIPE_D) * 0.1).astype(np.float32)
    arrays["pipe/x"] = rng.randn(4, 3, PIPE_D).astype(np.float32)
    arrays["pipe/y"] = rng.randn(4, 3, PIPE_D).astype(np.float32)
    arrays["pipe/tx"] = rng.randn(8, 4, PIPE_D).astype(np.float32)
    moe = jax.device_get(init_moe_params(jax.random.PRNGKey(4), D_MOE,
                                         H_MOE, E_MOE))
    for k, a in moe.items():
        arrays[f"moe/{k}"] = np.asarray(a)
    arrays["moe/x"] = rng.randn(T_MOE, D_MOE).astype(np.float32)
    np.savez(work / "inputs.npz", **arrays)
    spec = {"confs": {k: c.to_json() for k, c in confs.items()},
            "output": [{"conf": "tf", "layout": "2x2"},
                       {"conf": "tf", "layout": "1x4"}],
            "train": [{"name": n, "conf": c, "layout": lay,
                       "options": opt, "data": n, "n_batches": len(sz)}
                      for n, c, lay, opt, sz in TRAIN],
            "ckpt": {"conf": "tf", "data": "ckpt",
                     "n_batches": CKPT_BATCHES},
            "cli": CLI + ["--mesh", "batch=2,model=2"]}
    with open(work / "scenarios.json", "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, WORLD_SIZE="4", OMP_NUM_THREADS="1",
               HOME=str(work))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(work)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=str(work))
             for r in range(4)]

    want = {"megatron": _jax_megatron(arrays),
            "output": np.asarray(jax_output(
        confs["tf"], jax.tree_util.tree_map(jnp.asarray, params["tf"]),
        jnp.asarray(arrays["output/x"])))}
    for name, conf_name, layout, options, _ in TRAIN:
        rec = _Recorder()
        t = _jax_trainer(confs[conf_name], params[conf_name], layout,
                         **options)
        t.listeners = [rec]
        t.fit(batches[name], epochs=1)
        want[name] = {"params": jax.tree_util.tree_leaves(
            jax.device_get(t.state.params)),
            "updater": jax.tree_util.tree_leaves(
                jax.device_get(t.state.updater)),
            "scores": rec.scores}
    rec = _Recorder()
    t = _jax_trainer(confs["tf"], params["tf"], "2x2", zero1=True)
    t.listeners = [rec]
    t.fit(batches["ckpt"], epochs=1)
    want["ckpt"] = {"params": jax.tree_util.tree_leaves(
        jax.device_get(t.state.params)), "scores": rec.scores,
        "like": t.state, "plan": t.plan}
    want["pipeline"] = _jax_pipeline(arrays)
    want["moe"] = _jax_moe(jax.tree_util.tree_map(jnp.asarray, moe),
                           jnp.asarray(arrays["moe/x"]))
    for causal in (False, True):
        a = _jax_attention(arrays, causal)
        want[f"ring_{'causal' if causal else 'full'}"] = a
        want[f"ulysses_{'causal' if causal else 'full'}"] = a

    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    port = {f[:-4]: dict(np.load(work / "out" / f))
            for f in os.listdir(work / "out")}
    return {"work": work, "port": port, "jax": want, "confs": confs,
            "params": params, "batches": batches}


def _leaves(run, prefix):
    return [run[f"{prefix}/{i}"] for i in range(
        sum(1 for k in run if k.startswith(prefix + "/")))]


@pytest.mark.parametrize("part", ["z", "g", "dx", "dW1", "dW2"])
def test_megatron_collectives_give_the_whole_mlps_values_and_grads(runs,
                                                                   part):
    """copy-to-model (its backward all-reduces), reduce-from-model (its
    backward is the identity) and gather-from-model (its backward keeps
    this rank's slice) in an MLP split over 4 ranks: each rank's dx is the
    whole input's gradient, not 4 times it. f32, terms up to ~40: atol
    1e-4 (2.5e-6 of the largest)."""
    np.testing.assert_allclose(runs["port"]["megatron"][part],
                               runs["jax"]["megatron"][part], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("layout", ["2x2", "1x4"])
def test_transformer_output_under_the_model_axis_is_jaxs(runs, layout):
    np.testing.assert_allclose(runs["port"][f"output__{layout}"]["y"],
                               runs["jax"]["output"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_four_ranks_train_as_jaxs_plan_trainer(runs, name):
    """Two steps of the port's plan trainer against JAX's GSPMD plan
    step: params, the updater gathered whole, and every batch's score;
    the network holds the trained params whole after `fit`."""
    got, want = runs["port"][f"train__{name}"], runs["jax"][name]
    params = _leaves(got, "p")
    assert len(params) == len(want["params"])
    for a, b in zip(params, want["params"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    assert len(_leaves(got, "u")) == len(want["updater"])
    for a, b in zip(_leaves(got, "u"), want["updater"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                               atol=1e-5)
    assert bool(got["net_whole"])
    np.testing.assert_array_equal(
        got["net_params"], np.concatenate([a.reshape(-1) for a in params]))


def _ck(runs):
    return str(runs["work"] / "ck_tp_2x2")


@pytest.mark.parametrize("reader", ["load", "load_sharded",
                                    "load_sharded_into_a_plan"])
def test_jax_reads_the_ports_sharded_checkpoint_bitwise(runs, reader):
    """The 2 x 2 ZeRO-1 trainer's checkpoint, written after 2 batches in
    the sharded layout, read by JAX's `load`, `load_sharded` and
    `load_sharded` into JAX's own 2 x 2 plan shardings, equals the port's
    state gathered whole, bit for bit."""
    like = runs["jax"]["ckpt"]["like"]
    if reader == "load":
        params, updater, meta = jax_ckpt.load(
            _ck(runs), like_params=like.params, like_updater=like.updater)
    else:
        kw = {}
        if reader == "load_sharded_into_a_plan":
            plan = runs["jax"]["ckpt"]["plan"]
            kw = {"params_shardings": plan.param_shardings(like.params),
                  "updater_shardings": type(like.updater)(
                      *(plan.param_shardings(t) for t in like.updater))}
        params, updater, meta = jax_ckpt.load_sharded(
            _ck(runs), like_params=like.params, like_updater=like.updater,
            **kw)
    assert meta["layout"] == "sharded" and meta["step"] == 2
    assert meta["data_cursor"] == {"batches_done": 2}
    got = runs["port"]["ckpt"]
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(params)),
                    _leaves(got, "w/p")):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(updater)),
                    _leaves(got, "w/u")):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_the_sharded_checkpoint_holds_pieces_with_their_bounds(runs):
    """Each split leaf is written as every model rank's pieces (the
    head-aligned Wqkv three a rank), a whole leaf once."""
    with open(os.path.join(_ck(runs), "index.json")) as f:
        index = json.load(f)["leaves"]
    wqkv = index["params/1/Wqkv"]
    assert wqkv["shape"] == [32, 96] and len(wqkv["pieces"]) == 6
    # rank 0's pieces are q, k, v [0, 16) of each third, rank 1's [16, 32)
    assert [p["index"][1] for p in wqkv["pieces"]] == [
        [0, 16], [32, 48], [64, 80], [16, 32], [48, 64], [80, 96]]
    assert len(index["params/1/Wo"]["pieces"]) == 2
    assert index["params/1/Wo"]["pieces"][1]["index"] == [[16, 32], [0, 32]]
    assert len(index["params/0/W"]["pieces"]) == 1
    assert len(index["updater/.velocity/2/W1"]["pieces"]) == 2


@pytest.mark.parametrize("where", ["1x4", "one_rank"])
def test_a_2x2_checkpoint_resumes_on_another_topology(runs, where):
    """The 2 x 2 checkpoint (cursor 2) resumes on 1 x 4 (the ranks) and
    on one rank (here) and ends where JAX's uninterrupted 2 x 2 ZeRO-1
    run over the 4 batches ends."""
    want = runs["jax"]["ckpt"]
    if where == "1x4":
        got = runs["port"]["ckpt"]
        assert int(got["resumed"]) == 2
        params, scores = _leaves(got, "p"), list(got["scores"])
    else:
        ck = str(runs["work"] / "ck_one_rank")
        shutil.copytree(_ck(runs), ck)
        conf = MultiLayerConfiguration.from_json(
            runs["confs"]["tf"].to_json())
        net = MultiLayerNetwork(conf, device="cpu")
        net.params = params_from_numpy(runs["params"]["tf"], "cpu")
        rec = _Recorder()
        t = DataParallelTrainer(net, plan=ShardPlan(mesh=plan_mesh(
            {"batch": 1, "model": 1}, device="cpu")), listeners=[rec])
        t.fit(runs["batches"]["ckpt"], checkpoint_dir=ck)
        assert t.resumed_from_step == 2
        params = [a.numpy() for a in tree_leaves(t.state.params)]
        scores = rec.scores
    np.testing.assert_allclose(scores, want["scores"][2:], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(params, want["params"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["ring_full", "ring_causal",
                                  "ulysses_full", "ulysses_causal"])
def test_context_parallel_attention_matches_full_attention(runs, name):
    got, want = runs["port"][name], runs["jax"][name]
    np.testing.assert_allclose(got["o"], want["o"], rtol=2e-5, atol=2e-5)
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[g], want[g], rtol=1e-3, atol=1e-3,
                                   err_msg=g)


@pytest.mark.parametrize("part", ["forward", "grads", "training"])
def test_pipeline_of_four_stages_is_jaxs(runs, part):
    got, want = runs["port"]["pipeline"], runs["jax"]["pipeline"]
    if part == "forward":
        np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5,
                                   atol=1e-5)
    elif part == "grads":
        for k in ("gW", "gb"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    else:
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-4, atol=1e-6)
        assert got["losses"][-1] < got["losses"][0]
        np.testing.assert_allclose(got["trained_W"], want["trained_W"],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("part", ["y", "aux", "grads"])
def test_moe_over_four_shards_is_the_dense_reference(runs, part):
    got, want = runs["port"]["moe"], runs["jax"]["moe"]
    if part == "y":
        np.testing.assert_allclose(got["y"], want["y"], rtol=2e-4,
                                   atol=2e-4)
    elif part == "aux":
        np.testing.assert_allclose(float(got["aux"]), float(want["aux"]),
                                   rtol=1e-5)
    else:
        for k in ("router_grad", "gW1", "gb1", "gW2", "gb2"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_cli_trains_on_a_2x2_mesh_as_jaxs_and_one_rank(runs, tmp_path,
                                                       capsys, monkeypatch):
    """`train --mesh batch=2,model=2` at 4 ranks: the score within 1e-5
    relative of the JAX CLI's on the same mesh and of the port's run at
    one rank (batch=1,model=1). The port's nets start from JAX's initial
    params (the CLI's own draw from the torch generator differs), carried
    in through `MultiLayerNetwork.init`, here and in the ranks."""
    real = MultiLayerNetwork.init

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.params = params_from_numpy(runs["params"]["cli"], self.device)
        return self

    monkeypatch.setattr(MultiLayerNetwork, "init", init)
    got = runs["port"]["cli"]
    assert int(got["rc"]) == 0
    score = json.loads(str(got["line"]))["score"]
    assert jax_main(CLI + ["--mesh", "batch=2,model=2", "--output",
                           str(tmp_path / "jax")]) == 0
    jax_score = json.loads(capsys.readouterr().out.strip()
                           .splitlines()[-1])["score"]
    assert main(CLI + ["--mesh", "batch=1,model=1", "--output",
                       str(tmp_path / "one"), "--device", "cpu"]) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(score, jax_score, rtol=1e-5)
    np.testing.assert_allclose(score, one["score"], rtol=1e-5)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_ranks_import_neither_jax_nor_the_jax_package(runs, rank):
    assert list(runs["port"][f"imports_rank{rank}"]["leaked"]) == []
