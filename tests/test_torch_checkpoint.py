"""Crash-safe checkpointed `fit`, checkpoints across both packages, and the
port's fault points, after the JAX package's tests
(tests/test_reliability.py).

A SIGTERM (the handler `fit` installs, called in process) or
`request_stop_training` checkpoints and raises `TrainingInterrupted`; a
rerun on the same directory and stream resumes at the saved cursor and ends
bitwise equal to one uninterrupted run (on the CPU; the card's check is in
chip_smoke.py). Checkpoints carry params, the data cursor and metadata in
the JAX package's layout both ways. The data-parallel trainer's
checkpoints (its updater, step and mesh record too) cross both ways as
well, a JAX mesh checkpoint of 4 virtual devices resuming in the port
and stepping as JAX steps (rtol 2e-4, atol 2e-5), and the sharded layout
of JAX's tensor-parallel plan reads bit for bit. Inputs and weights come
from numpy seeds.
"""

import json
import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402

from deeplearning4j_tpu.cli.driver import main as jax_main  # noqa: E402
from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn import conf as jax_conf  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.optimize import updater as jax_updater  # noqa: E402,E501
from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint  # noqa: E402,E501
from deeplearning4j_tpu_torch.cli.driver import main  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: E402
    ListDataSetIterator, PrefetchIterator)
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.optimize.updater import UpdaterState  # noqa: E402,E501
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.parallel.data_parallel import (  # noqa: E402
    DataParallelTrainer, gather_updater)
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from deeplearning4j_tpu_torch.reliability import (  # noqa: E402
    TrainingInterrupted, faults)

VOCAB, SEQ, ROWS, BATCHES = 20, 6, 3, 5
WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dogs"]


@pytest.fixture(autouse=True)
def _no_faults():
    faults.reset()
    yield
    faults.reset()


def _conf():
    jconf = jax_zoo.char_lstm(VOCAB, hidden=8, n_layers=2, sparse_labels=True,
                              embed=6)
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _stream(n=BATCHES, seed=3):
    ids = np.random.RandomState(seed).randint(0, VOCAB,
                                              (n * ROWS, SEQ + 1))
    data = DataSet(ids[:, :-1].astype(np.int32),
                   ids[:, 1:].reshape(-1).astype(np.int32))
    return ListDataSetIterator(data, ROWS)


def _net(seed=7, **kw):
    return ml.MultiLayerNetwork(_conf()[1], device="cpu", seed=seed,
                                **kw).init()


def _leaves(net):
    return [t.clone() for t in tree_leaves(net.params)]


class _SigtermAfter:
    """A listener that calls the installed SIGTERM handler after `after`
    batches, standing in for the signal's delivery."""

    def __init__(self, after):
        self.after, self.n = after, 0

    def iteration_done(self, model, iteration, score):
        self.n += 1
        if self.n == self.after:
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler), "fit did not install a SIGTERM handler"
            handler(signal.SIGTERM, None)


def test_sigterm_mid_stream_then_rerun_is_bitwise_one_run(tmp_path):
    ck = str(tmp_path / "ck")
    ref = _net()
    ref.fit(_stream())
    before = signal.getsignal(signal.SIGTERM)

    n1 = _net()
    n1.set_listeners([_SigtermAfter(2)])
    with pytest.raises(TrainingInterrupted):
        n1.fit(_stream(), checkpoint_dir=ck)
    assert signal.getsignal(signal.SIGTERM) is before
    _, _, meta = checkpoint.load(ck)
    assert meta["data_cursor"] == {"batches_done": 2} and meta["step"] == 2
    assert meta["metadata"]["rng_key"] == [int(v) for v in n1._key]
    assert "torch_generator_state" not in meta["metadata"]

    n2 = _net()  # a fresh process
    n2.fit(PrefetchIterator(_stream(), device="cpu"), checkpoint_dir=ck)
    assert n2.resumed_from_batch == 2
    assert n2.step_cache.stats.steps == BATCHES - 2
    for a, b in zip(tree_leaves(n2.params), tree_leaves(ref.params)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    _, _, meta = checkpoint.load(ck)
    assert meta["data_cursor"]["batches_done"] == BATCHES
    assert n2.checkpoints_written == 1 and n2.checkpoint_write_seconds > 0


def test_periodic_checkpoints_and_request_stop_training(tmp_path):
    ck = str(tmp_path / "ck")
    net = _net(seed=1)
    saved = []
    real_save = net._save_checkpoint
    net._save_checkpoint = lambda d, n: (saved.append(n), real_save(d, n))
    net.fit(_stream(), checkpoint_dir=ck, checkpoint_every_n_batches=2)
    assert saved == [2, 4, 5]
    assert os.path.isdir(ck) and not os.path.isdir(ck + ".bak")

    class _Stop:
        def iteration_done(self, model, iteration, score):
            model.request_stop_training()

    net2 = _net(seed=1)
    net2.set_listeners([_Stop()])
    with pytest.raises(TrainingInterrupted):
        net2.fit(_stream(), checkpoint_dir=str(tmp_path / "ck2"),
                 auto_resume=False)
    _, _, meta = checkpoint.load(str(tmp_path / "ck2"))
    assert meta["data_cursor"]["batches_done"] == 1
    # auto_resume=False starts over even where a checkpoint exists
    net3 = _net(seed=1)
    net3.fit(_stream(), checkpoint_dir=ck, auto_resume=False)
    assert net3.resumed_from_batch is None
    assert net3.step_cache.stats.steps == BATCHES


def test_port_checkpoint_loads_in_jax_and_jax_checkpoint_in_the_port(
        tmp_path):
    jconf, tconf = _conf()
    net = _net(seed=2)
    net.fit(_stream(n=2))
    port_dir = str(tmp_path / "port")
    checkpoint.save(port_dir, net.params, conf=tconf, step=4,
                    data_cursor={"batches_done": 4},
                    metadata={"note": "port"})
    like = jax_ml.init_params(jconf, jax.random.PRNGKey(0))
    jparams, _, meta = jax_checkpoint.load_resilient(port_dir,
                                                     like_params=like)
    assert meta["data_cursor"] == {"batches_done": 4}
    assert meta["step"] == 4 and meta["metadata"] == {"note": "port"}
    for a, b in zip(tree_leaves(net.params), jax.tree_util.tree_leaves(
            jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    jax_dir = str(tmp_path / "jax")
    jax_checkpoint.save(jax_dir, jparams, conf=jconf, step=9,
                        data_cursor={"batches_done": 9},
                        metadata={"note": "jax"})
    params, _, meta = checkpoint.load_resilient(jax_dir,
                                                like_params=net.params)
    assert meta["data_cursor"] == {"batches_done": 9}
    assert meta["step"] == 9 and meta["metadata"] == {"note": "jax"}
    for a, b in zip(tree_leaves(params), tree_leaves(net.params)):
        assert torch.equal(a, b)
    # a JAX checkpoint resumes a port fit at its cursor
    resumed = _net(seed=2)
    resumed.fit(_stream(n=BATCHES), checkpoint_dir=jax_dir)
    assert resumed.resumed_from_batch == 9  # past the stream: nothing to do
    assert resumed.step_cache.stats.steps == 0


def test_load_refuses_another_model_and_falls_back_past_a_torn_one(tmp_path):
    d = str(tmp_path / "ck")
    net = _net(seed=4)
    checkpoint.save(d, net.params, step=7)
    other = ml.MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jax_zoo.char_lstm(VOCAB, hidden=4, n_layers=2, sparse_labels=True,
                          embed=6).to_json()), device="cpu").init()
    with pytest.raises(checkpoint.CheckpointFormatError, match="shape"):
        checkpoint.load_resilient(d, like_params=other.params)
    shutil.copytree(d, d + ".bak")
    with open(os.path.join(d, "arrays.npz"), "wb") as f:
        f.write(b"torn")
    params, _, meta = checkpoint.load_resilient(d, like_params=net.params)
    assert meta["step"] == 7
    for a, b in zip(tree_leaves(params), tree_leaves(net.params)):
        assert torch.equal(a, b)
    assert checkpoint.load_resilient(str(tmp_path / "absent")) is None


def test_an_armed_save_fault_leaves_the_previous_checkpoint_readable(
        tmp_path):
    d = str(tmp_path / "ck")
    net = _net(seed=5)
    checkpoint.save(d, net.params, step=1, data_cursor={"batches_done": 1})
    first = _leaves(net)
    net.fit(_stream(n=1))
    faults.arm("checkpoint.save", "oserror")
    with pytest.raises(OSError):
        checkpoint.save(d, net.params, step=2,
                        data_cursor={"batches_done": 2})
    params, _, meta = checkpoint.load_resilient(d, like_params=net.params)
    assert meta["data_cursor"] == {"batches_done": 1}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), first))
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    # an armed load fault stands for an unreadable directory: skipped
    faults.arm("checkpoint.load", nth=1)
    assert checkpoint.load_resilient(d, like_params=net.params) is None
    assert faults.stats()["armed"]["checkpoint.load"]["fired"] == 1


def test_a_prefetch_worker_fault_reaches_the_consumer_once():
    faults.arm("prefetch.worker", nth=3)
    got = []
    with pytest.raises(faults.FaultInjected):
        for b in PrefetchIterator(_stream(), device="cpu"):
            got.append(b)
    assert faults.hits("prefetch.worker") == 3
    assert len(got) == 0  # two staged, none handed over before the fault
    assert len(list(PrefetchIterator(_stream(), device="cpu"))) == BATCHES


def _corpus(tmp_path, chars=300):
    rng = np.random.RandomState(0)
    text = " ".join(rng.choice(WORDS) for _ in range(chars // 4))[:chars]
    path = tmp_path / "corpus.txt"
    path.write_text(text)
    return f"text:{path}:8"


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_cli_checkpoint_dir_resumes_and_keeps_the_jax_train_keys(
        tmp_path, capsys, monkeypatch):
    uri = _corpus(tmp_path)
    common = ["train", "--input", uri, "--zoo", "char_lstm:layers=2,hidden=8",
              "--properties", "epochs=2,batch=8,checkpoint_every=2"]
    assert main(common + ["--output", str(tmp_path / "one"), "--device",
                          "cpu", "--checkpoint-dir",
                          str(tmp_path / "ck1")]) == 0
    one = _last_json(capsys.readouterr().out)
    # the JAX package's train line has the same keys with or without a
    # checkpoint dir; its checkpointed stream selects label rows by example
    # index (ROADMAP.md queue C), which a text corpus's B*T rows defeat
    assert jax_main(["train", "--input", uri, "--zoo",
                     "char_lstm:layers=2,hidden=8", "--properties",
                     "epochs=1", "--output", str(tmp_path / "jax")]) == 0
    want = _last_json(capsys.readouterr().out)
    assert set(one) == set(want)
    assert one["resumed_from_step"] is None
    assert one["disk_cache"] == {k: 0 for k in want["disk_cache"]}
    assert one["cache_misses"] >= 1 and one["cache_hits"] >= 1
    assert one["checkpoint_write_seconds"] > 0

    # stopped after 3 batches (the run's SIGTERM path), then rerun
    real = ml.MultiLayerNetwork._fit_batch
    calls = []

    def stop_after_three(self, x, y):
        real(self, x, y)
        calls.append(1)
        if len(calls) == 3:
            self.request_stop_training()

    ck = str(tmp_path / "ck2")
    monkeypatch.setattr(ml.MultiLayerNetwork, "_fit_batch", stop_after_three)
    assert main(common + ["--output", str(tmp_path / "two"), "--device",
                          "cpu", "--checkpoint-dir", ck]) == 0
    stopped = _last_json(capsys.readouterr().out)
    assert stopped["interrupted"] is True and stopped["checkpoint"] == ck
    monkeypatch.setattr(ml.MultiLayerNetwork, "_fit_batch", real)
    assert main(common + ["--output", str(tmp_path / "two"), "--device",
                          "cpu", "--checkpoint-dir", ck]) == 0
    two = _last_json(capsys.readouterr().out)
    assert two["resumed_from_step"] == 3
    a = checkpoint.load_network(str(tmp_path / "one"), device="cpu")
    b = checkpoint.load_network(str(tmp_path / "two"), device="cpu")
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(p, q)
    assert two["score"] == one["score"]


# -- the data-parallel trainer's checkpoints (tests/test_elastic_resume.py) --

def _dp_conf():
    """The JAX package's elastic-resume net: 4 -> 8 -> 3, AdaGrad."""
    jc = jax_conf
    base = jc.NeuralNetConfiguration(
        n_in=4, n_out=3, lr=0.1,
        optimization_algo=jc.OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT,
        num_iterations=5)
    jconf = (jc.list_builder(base, 2).hidden_layer_sizes([8], 4, 3)
             .override(1, layer_type=jc.LayerType.OUTPUT)
             .pretrain(False).backprop(True).build())
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _dp_batches(n=48, bs=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, size=n)]
    return [(x[i:i + bs], y[i:i + bs]) for i in range(0, n, bs)]


def _dp_pair(n_jax=1, **kw):
    """(JAX trainer on `n_jax` virtual devices, port trainer at world size
    1) on JAX's initial params."""
    from deeplearning4j_tpu.parallel.data_parallel import \
        DataParallelTrainer as JaxTrainer
    from deeplearning4j_tpu.parallel.mesh import make_mesh as jax_mesh

    jconf, tconf = _dp_conf()
    jnet = jax_ml.MultiLayerNetwork(jconf).init()
    net = ml.MultiLayerNetwork(tconf, device="cpu")
    net.params = checkpoint.params_from_numpy(jax.device_get(jnet.params),
                                              "cpu")
    jt = JaxTrainer(jnet, jax_mesh({"dp": n_jax},
                                   devices=jax.devices()[:n_jax]), **kw)
    return jt, DataParallelTrainer(net, make_mesh({"dp": 1}, device="cpu"),
                                   **kw)


def _assert_close_trees(got, want):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("zero1", [False, True])
def test_jax_mesh_checkpoint_resumes_in_the_port_and_steps_as_jax(
        tmp_path, zero1):
    """A checkpoint JAX's trainer wrote on 4 virtual devices (with the
    updater sharded under zero1) restores into the port's trainer, whose
    next step matches JAX's next step."""
    ck = str(tmp_path / "ck")
    batches = _dp_batches()
    jt, t = _dp_pair(n_jax=4, zero1=zero1)
    jt.fit(batches[:3], checkpoint_dir=ck, checkpoint_every_n_batches=1)
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f)["mesh"]["shape"] == {"dp": 4}
    assert t.restore(ck) == 3
    jt.fit([batches[3]])
    t.fit([batches[3]])
    assert t.state.step == int(jt.state.step) == 4
    _assert_close_trees(t.state.params, jt.state.params)
    _assert_close_trees(gather_updater(t.state, t.mesh), jt.state.updater)


def test_port_trainer_checkpoint_loads_in_jax_and_trains_on(tmp_path):
    ck = str(tmp_path / "ck")
    batches = _dp_batches()
    jt, t = _dp_pair()
    t.fit(batches[:3], checkpoint_dir=ck, checkpoint_every_n_batches=1)
    like_u = jax_updater.init_updater(jt.state.params)
    _, updater, meta = jax_checkpoint.load(ck, like_params=jt.state.params,
                                           like_updater=like_u)
    assert meta["mesh"] == {"axis_names": ["dp"], "shape": {"dp": 1},
                            "zero1": False}
    assert meta["data_cursor"] == {"batches_done": 3} and meta["step"] == 3
    _assert_close_trees(t.state.updater, updater)
    assert jt.restore(ck) == 3
    jt.fit([batches[3]])
    t.fit([batches[3]])
    _assert_close_trees(t.state.params, jt.state.params)


def test_jax_sharded_checkpoint_reads_exactly(tmp_path):
    """The sharded layout JAX's tensor-parallel plan writes (one piece a
    unique shard, tests/test_tp_mesh.py) assembles through the port's
    `load` and `load_sharded` bit for bit, params and updater."""
    from deeplearning4j_tpu.parallel.plan import ShardPlan, plan_mesh

    jconf = jax_zoo.char_transformer(32, d_model=16, n_blocks=2, n_heads=2,
                                     max_seq_len=32)
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=0).init()
    plan = ShardPlan(mesh=plan_mesh({"batch": 2, "model": 4}))
    shard = plan.param_shardings(jnet.params)
    params = jax.tree_util.tree_map(jax.device_put, jnet.params, shard)
    upd = jax_updater.UpdaterState(
        adagrad_hist=jax.tree_util.tree_map(
            lambda a, s: jax.device_put(a * a, s), jnet.params, shard),
        velocity=jax.tree_util.tree_map(
            lambda a, s: jax.device_put(-a, s), jnet.params, shard))
    d = str(tmp_path / "sharded")
    jax_checkpoint.save_sharded(d, params, upd, conf=jconf, step=5)
    net = ml.MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    like_u = UpdaterState(adagrad_hist=net.params, velocity=net.params)
    got, got_u, meta = checkpoint.load(d, like_params=net.params,
                                       like_updater=like_u)
    assert meta["step"] == 5 and meta["layout"] == "sharded"
    for a, b in zip(tree_leaves((got, got_u)),
                    jax.tree_util.tree_leaves((jnet.params, upd))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    stats = {}
    again, _, _ = checkpoint.load_sharded(d, like_params=net.params,
                                          stats=stats)
    assert stats["pieces_read"] > len(tree_leaves(net.params))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again),
                                                  tree_leaves(got)))
    with pytest.raises(checkpoint.CheckpointFormatError, match="like_params"):
        checkpoint.load(d)


@pytest.mark.parametrize("model_rank", [0, 3])
def test_sharded_layouts_both_ways_and_into_a_ranks_shards(tmp_path,
                                                           model_rank):
    """The port's `save_sharded` at one rank is read by JAX's `load` bit
    for bit; a checkpoint of JAX's 2 x 4 plan (Wqkv cut in contiguous
    thirds of 3n/4) reads into one model rank's head-aligned shards of a
    model axis of 4 (`load(tp=)`), which equal the whole leaves cut by
    `tensor.shard_leaf`; so does the gathered layout."""
    from deeplearning4j_tpu.parallel.plan import ShardPlan, plan_mesh
    from deeplearning4j_tpu_torch.parallel import tensor

    jconf = jax_zoo.char_transformer(32, d_model=16, n_blocks=2, n_heads=4,
                                     max_seq_len=32)
    jnet = jax_ml.MultiLayerNetwork(jconf, seed=0).init()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    whole = checkpoint.params_from_numpy(jax.device_get(jnet.params), "cpu")
    mine = str(tmp_path / "port")
    checkpoint.save_sharded(mine, whole, conf=conf, step=3)
    got, _, meta = jax_checkpoint.load(mine, like_params=jnet.params)
    assert meta["layout"] == "sharded" and meta["step"] == 3
    for a, b in zip(jax.tree_util.tree_leaves(got), tree_leaves(whole)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    plan = ShardPlan(mesh=plan_mesh({"batch": 2, "model": 4}))
    theirs = str(tmp_path / "jax")
    jax_checkpoint.save_sharded(theirs, jax.tree_util.tree_map(
        jax.device_put, jnet.params, plan.param_shardings(jnet.params)),
        conf=jconf)
    tp = tensor.TensorParallel(None, 4, model_rank,
                               tensor.tp_layout(conf, 4))
    from deeplearning4j_tpu_torch.parallel.data_parallel import shard_params

    like = shard_params(whole, tp)
    gathered = checkpoint.save(str(tmp_path / "gathered"), whole, conf=conf)
    for d in (mine, theirs, gathered):
        local, _, _ = checkpoint.load(d, like_params=like, tp=tp)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(local),
                                                      tree_leaves(like)))
    assert tuple(like[1]["Wqkv"].shape) == (16, 12)


def test_trainer_sigterm_checkpoints_then_raises(tmp_path):
    ck = str(tmp_path / "ck")
    batches = _dp_batches()
    _, t = _dp_pair()
    t.listeners = [_SigtermAfter(2)]
    with pytest.raises(TrainingInterrupted):
        t.fit(batches, epochs=2, checkpoint_dir=ck,
              checkpoint_every_n_batches=100)
    _, _, meta = checkpoint.load(ck)
    assert meta["data_cursor"]["batches_done"] == 2
    _, ref = _dp_pair()
    ref.fit(batches, epochs=2)
    _, t2 = _dp_pair()
    t2.fit(batches, epochs=2, checkpoint_dir=ck)
    assert t2.resumed_from_step == 2
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((t2.state.params, t2.state.updater)),
        tree_leaves((ref.state.params, ref.state.updater))))


@pytest.mark.parametrize("damage", ["truncate_npz", "drop_meta"])
def test_corrupt_trainer_checkpoint_falls_back_to_bak(tmp_path, damage):
    ck = str(tmp_path / "ck")
    batches = _dp_batches()
    _, t = _dp_pair()
    t.fit(batches[:3], checkpoint_dir=ck, checkpoint_every_n_batches=1)
    shutil.copytree(ck, ck + ".bak")
    if damage == "truncate_npz":
        p = os.path.join(ck, "arrays.npz")
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) // 2)
    else:
        os.remove(os.path.join(ck, "meta.json"))
    _, t2 = _dp_pair()
    t2.fit(batches, epochs=2, checkpoint_dir=ck)
    assert t2.resumed_from_step == 3


def test_future_format_version_fails_in_one_line(tmp_path):
    ck = str(tmp_path / "ck")
    _, t = _dp_pair()
    t.fit(_dp_batches()[:1], checkpoint_dir=ck)
    with open(os.path.join(ck, "meta.json")) as f:
        meta = json.load(f)
    meta["format_version"] = 99
    with open(os.path.join(ck, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(checkpoint.CheckpointFormatError,
                       match="format_version=99"):
        checkpoint.load(ck)
    _, t2 = _dp_pair()
    with pytest.raises(checkpoint.CheckpointFormatError):
        t2.fit(_dp_batches(), checkpoint_dir=ck)


def test_structurally_incompatible_trainer_tree_fails_actionably(tmp_path):
    ck = str(tmp_path / "ck")
    _, t = _dp_pair()
    t.fit(_dp_batches()[:1], checkpoint_dir=ck)
    wide = jax_zoo.mlp(4, [16], 3)
    other = DataParallelTrainer(
        ml.MultiLayerNetwork(MultiLayerConfiguration.from_json(
            wide.to_json()), device="cpu").init(),
        make_mesh({"dp": 1}, device="cpu"))
    with pytest.raises(checkpoint.CheckpointFormatError, match="shape"):
        other.restore(ck)
    # a network's checkpoint holds no updater: the trainer cannot resume it
    net_dir = str(tmp_path / "net")
    checkpoint.save(net_dir, t.net.params, conf=t.net.conf)
    with pytest.raises(checkpoint.CheckpointFormatError, match="missing"):
        t.restore(net_dir)
