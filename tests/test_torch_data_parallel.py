"""The port's data-parallel trainer at world size 1 vs the JAX package's on
a mesh of one device.

Both take the same numpy-seeded batches and JAX's initial params, carried
across. The port runs in this process over a gloo group of one
(`parallel.mesh.make_mesh(device="cpu")`); JAX on one of the conftest's
virtual CPU devices. Tolerances: rtol 2e-4, atol 2e-5 on params and
updater state (the JAX package's dp-vs-single-device tolerances,
`tests/test_parallel.py:86-101`), 1e-5 on scores, bitwise where the port
is held to itself. World size 2 is `tests/test_torch_dp_ranks.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn import conf as jax_conf  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet  # noqa: E402,E501
from deeplearning4j_tpu.optimize import updater as jax_updater  # noqa: E402
from deeplearning4j_tpu.parallel import averaging as jax_averaging  # noqa: E402,E501
from deeplearning4j_tpu.parallel.data_parallel import \
    DataParallelTrainer as JaxTrainer  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import updater  # noqa: E402
from deeplearning4j_tpu_torch.optimize.listeners import CheckpointListener  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    ParameterAggregator, average_pytrees, merge)
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.parallel import data_parallel as dp  # noqa: E402,E501
from deeplearning4j_tpu_torch.parallel.checkpoint import params_from_numpy  # noqa: E402,E501
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh, make_mesh, mesh_axes, rank_device, shard_batch)

RTOL, ATOL = 2e-4, 2e-5


def _mesh():
    return make_mesh({"dp": 1}, device="cpu")


def _with(conf, **kw):
    return conf.replace(confs=tuple(c.replace(**kw) for c in conf.confs))


def _pair(jconf, seed=0, **port_kw):
    """(JAX net, port net) on the same params: JAX's init carried across;
    `port_kw` replaces fields of every layer conf of the port's."""
    jnet = JaxNet(jconf, seed=seed).init()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    net = MultiLayerNetwork(_with(conf, **port_kw) if port_kw else conf,
                            device="cpu")
    net.params = params_from_numpy(jax.device_get(jnet.params), "cpu")
    return jnet, net


def _trainers(jconf, seed=0, port_kw=None, **kw):
    jnet, net = _pair(jconf, seed, **(port_kw or {}))
    jt = JaxTrainer(jnet, jax_mesh({"dp": 1}, devices=jax.devices()[:1]),
                    **kw)
    return jt, dp.DataParallelTrainer(net, _mesh(), **kw)


def _assert_trees(got, want, rtol=RTOL, atol=ATOL):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=atol)


def _assert_states(t, jt):
    _assert_trees(t.state.params, jt.state.params)
    _assert_trees(dp.gather_updater(t.state, t.mesh), jt.state.updater)
    assert t.state.step == int(jt.state.step)


def _mlp_batches(n_batches=3, rows=8, n_in=12, n_out=3, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(rows, n_in).astype(np.float32),
             np.eye(n_out, dtype=np.float32)[rng.randint(0, n_out, rows)])
            for _ in range(n_batches)]


def _states_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        tree_leaves((a.params, a.updater)), tree_leaves((b.params,
                                                          b.updater))))


UPDATERS = {
    "adam": dict(updater="adam", lr=0.01),
    "sgd_momentum_after": dict(momentum=0.5, momentum_after=((1, 0.9),)),
    "adagrad_reset": dict(use_adagrad=True, adagrad_reset_iterations=2,
                          momentum=0.0),
}


@pytest.mark.parametrize("which", sorted(UPDATERS))
def test_sync_steps_keep_the_updater_across_batches_as_jax(which):
    """Three sync steps: the updater state persists, so Adam's bias
    corrections, the momentum schedule and AdaGrad's reset follow the
    trainer's step count, as in JAX."""
    conf = _with(jax_zoo.mlp(12, [16], 3), **UPDATERS[which])
    jt, t = _trainers(conf)
    batches = _mlp_batches()
    want = jt.fit(batches)
    got = t.fit(batches)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    _assert_states(t, jt)


def test_iteration_constants_are_the_solver_runs_numbers():
    """The tensor input reproduces what an int iteration bakes in: the
    same step and state bit for bit, at every iteration of the schedule."""
    conf = jax_conf.NeuralNetConfiguration(
        updater="", use_adagrad=True, adagrad_reset_iterations=2,
        momentum=0.5, momentum_after=((2, 0.8),))
    adam = conf.replace(updater="adam")
    rng = np.random.RandomState(1)
    g = {"W": torch.from_numpy(rng.randn(3, 4).astype(np.float32))}
    p = {"W": torch.from_numpy(rng.randn(3, 4).astype(np.float32))}
    for c in (conf, adam):
        tc = MultiLayerConfiguration.from_json(
            jax_conf.MultiLayerConfiguration(confs=(c,)).to_json()).conf(0)
        st = updater.init_updater(p)
        st2 = st
        for it in range(4):
            consts = torch.from_numpy(updater.iteration_constants(tc, it))
            a, st = updater.adjust_gradient(tc, it, g, p, st)
            b, st2 = updater.adjust_gradient(tc, 0, g, p, st2,
                                             consts=consts)
            assert torch.equal(a["W"], b["W"])
            assert all(torch.equal(x, y) for x, y in zip(
                tree_leaves(st), tree_leaves(st2)))


@pytest.mark.parametrize("fused", [False, True])
def test_adjust_gradient_auto_matches_jax(fused):
    conf = jax_conf.NeuralNetConfiguration(updater="adam", lr=0.01,
                                           fused_updater=fused,
                                           gradient_clip_norm=0.5)
    tc = MultiLayerConfiguration.from_json(
        jax_conf.MultiLayerConfiguration(confs=(conf,)).to_json()).conf(0)
    rng = np.random.RandomState(2)
    tree = ({"W": rng.randn(3, 4), "b": rng.randn(4)},
            {"W": rng.randn(4, 2)})
    grads = [{k: v.astype(np.float32) for k, v in d.items()} for d in tree]
    params = [{k: (v * 0.5).astype(np.float32) for k, v in d.items()}
              for d in tree]
    jg, jp = jax.tree_util.tree_map(jnp.asarray, (grads, params))
    tg = tuple({k: torch.from_numpy(v) for k, v in d.items()} for d in grads)
    tp = tuple({k: torch.from_numpy(v) for k, v in d.items()}
               for d in params)
    ja, jst = jax_updater.adjust_gradient_auto(
        conf, 3, jg, jp, jax_updater.init_updater(jp))
    a, st = updater.adjust_gradient_auto(tc, 3, tg, tp,
                                         updater.init_updater(tp))
    _assert_trees(a, ja, 1e-6, 1e-7)
    _assert_trees(st, jst, 1e-6, 1e-7)


def test_grad_accum_matches_the_plain_step_and_jax():
    conf = jax_zoo.mlp(12, [16], 3)
    batches = _mlp_batches(n_batches=2)
    jt, t = _trainers(conf, grad_accum=2)
    _, plain = _trainers(conf)
    np.testing.assert_allclose(t.fit(batches), jt.fit(batches), rtol=1e-5,
                               atol=1e-5)
    _assert_states(t, jt)
    plain.fit(batches)
    _assert_trees(t.state.params,
                  [{k: v.numpy() for k, v in d.items()}
                   for d in plain.state.params], 2e-5, 2e-6)


def test_grad_accum_guards_raise_as_jax():
    _, net = _pair(jax_zoo.mlp(4, [8], 2))
    with pytest.raises(ValueError, match="mode='sync'"):
        dp.DataParallelTrainer(net, _mesh(), mode="averaging", grad_accum=2)
    with pytest.raises(ValueError, match="grad_accum"):
        dp.make_dp_train_step(MultiLayerConfiguration.from_json(
            jax_zoo.vgg_cifar10(width=8).to_json()), _mesh(), grad_accum=2)
    with pytest.raises(ValueError, match="grad_accum"):
        dp.make_dp_train_step(net.conf, _mesh(), masked=True, grad_accum=2)
    t = dp.DataParallelTrainer(net, _mesh(), grad_accum=3)
    x, y = _mlp_batches(1, rows=4, n_in=4, n_out=2)[0]
    with pytest.raises(ValueError, match="not divisible by grad_accum"):
        t._step(t.state, *shard_batch(t.mesh, (x, y)), (0, 0))


def test_averaging_round_of_three_local_steps_matches_jax():
    conf = jax_zoo.mlp(12, [16], 3)
    jt, t = _trainers(conf, mode="averaging", local_steps=3)
    batches = _mlp_batches(n_batches=2)
    np.testing.assert_allclose(t.fit(batches), jt.fit(batches), rtol=1e-5,
                               atol=1e-5)
    _assert_states(t, jt)
    assert t.state.step == 6


def _bn_conf():
    jc = jax_conf
    opt = jc.OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT
    kw = dict(lr=0.1, optimization_algo=opt)
    return jc.MultiLayerConfiguration(confs=(
        jc.NeuralNetConfiguration(n_in=6, n_out=6, activation="tanh", **kw),
        jc.NeuralNetConfiguration(layer_type=jc.LayerType.BATCH_NORM,
                                  n_in=6, n_out=6, **kw),
        jc.NeuralNetConfiguration(layer_type=jc.LayerType.OUTPUT, n_in=6,
                                  n_out=3, **kw)))


@pytest.mark.parametrize("mode", ["sync", "averaging"])
def test_batchnorm_net_advances_its_ema_as_jax(mode):
    """The sync step advances the EMA from the (here one rank's) summed
    moments; the averaging round from each local step's moments, then
    averages it with the params."""
    rng = np.random.RandomState(3)
    batches = [(rng.randn(16, 6).astype(np.float32) * 0.5,
                np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)])
               for _ in range(2)]
    jt, t = _trainers(_bn_conf(), mode=mode, local_steps=2)
    np.testing.assert_allclose(t.fit(batches), jt.fit(batches), rtol=1e-5,
                               atol=1e-5)
    _assert_states(t, jt)
    assert float(t.state.params[1]["ema_w"]) > 0
    # the network took the trained params, EMA included, in place
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(t.net.params), tree_leaves(t.state.params)))
    with pytest.raises(ValueError, match="zero1"):
        dp.DataParallelTrainer(t.net, _mesh(), zero1=True)


def test_dropout_net_draws_the_folded_keys_of_jax():
    """Dropout masks come from fold_in(key, 0) of each batch's key, which
    JAX's shard_map folds in with the axis index; the key stream after
    `fit` is JAX's."""
    conf = jax_zoo.mlp(12, [16], 3)
    conf = conf.replace(confs=(conf.confs[0].replace(dropout=0.5),)
                        + conf.confs[1:])
    jt, t = _trainers(conf, seed=4)
    batches = _mlp_batches(seed=5)
    np.testing.assert_allclose(t.fit(batches), jt.fit(batches), rtol=1e-5,
                               atol=1e-5)
    _assert_states(t, jt)
    assert tuple(t._key) == tuple(int(v) for v in np.asarray(jt._key))


def test_char_transformer_on_the_plain_kernel_versions_matches_jax():
    """The port's attention takes the flash path, whose kernels run their
    plain versions on the CPU; JAX's shard_map cannot hold its Pallas call
    in interpret mode (check_vma), so JAX attends densely, as its CPU
    "auto" does. SGD with momentum, not the zoo's Adam: the key part of
    the qkv bias has an exactly zero gradient (a softmax row does not move
    when every score shifts alike), and Adam scales the rounding noise
    there up to +-lr in both packages alike; the MLP cases hold Adam."""
    conf = _with(jax_zoo.char_transformer(
        13, d_model=32, n_blocks=2, n_heads=2, max_seq_len=8,
        sparse_labels=True, fused_updater=True, attention_fused_bwd=True),
        updater="sgd", lr=0.1, momentum=0.9)
    rng = np.random.RandomState(6)
    batches = []
    for _ in range(2):
        ids = rng.randint(0, 13, (2, 9))
        batches.append((ids[:, :-1].astype(np.int32),
                        ids[:, 1:].reshape(-1).astype(np.int32)))
    jt, t = _trainers(conf, port_kw={"attention_impl": "flash"})
    np.testing.assert_allclose(t.fit(batches), jt.fit(batches), rtol=1e-5,
                               atol=1e-5)
    _assert_states(t, jt)


def test_cached_program_is_bitwise_the_eager_step():
    """The trainer's step through its `DPStepCache` (on the CPU the program
    runs uncaptured, with the same keys, inputs and writes) equals the
    step built without a cache, bit for bit, over three batches; the books
    count one miss and then hits."""
    conf = MultiLayerConfiguration.from_json(_with(
        jax_zoo.mlp(12, [16], 3), updater="adam", lr=0.01).to_json())
    _, net = _pair(_with(jax_zoo.mlp(12, [16], 3), updater="adam",
                         lr=0.01))
    t = dp.DataParallelTrainer(net, _mesh())
    eager = dp.make_dp_train_step(conf, t.mesh)
    state = dp.init_train_state(net)
    for x, y in _mlp_batches():
        key = t._next_key()
        xs, ys = shard_batch(t.mesh, (x, y))
        t.state, s1 = t._step(t.state, xs, ys, key)
        state, s2 = eager(state, xs, ys, key)
        assert torch.equal(s1, s2)
        assert _states_equal(t.state, state)
    books = t.compile_cache.stats.as_dict()
    assert (books["misses"], books["hits"]) == (1, 2)
    assert t.compile_cache.kind == "dp-step-cache"


def test_zero1_at_one_rank_is_bitwise_sync_and_checkpoints_whole():
    conf = _with(jax_zoo.mlp(12, [16], 3), updater="adam", lr=0.01,
                 fused_updater=True)
    jt, z = _trainers(conf, zero1=True)
    _, s = _trainers(conf)
    batches = _mlp_batches()
    z.fit(batches)
    s.fit(batches)
    assert _states_equal(z.state._replace(updater=dp.gather_updater(
        z.state, z.mesh)), s.state)
    jt.fit(batches)
    _assert_states(z, jt)


def test_trainer_guards_raise_as_jax():
    _, net = _pair(jax_zoo.mlp(4, [8], 2))
    with pytest.raises(ValueError, match="mode='sync'"):
        dp.DataParallelTrainer(net, _mesh(), mode="averaging", zero1=True)
    with pytest.raises(ValueError, match="grad_accum"):
        dp.DataParallelTrainer(net, _mesh(), zero1=True, grad_accum=2)
    with pytest.raises(ValueError, match="unknown mode"):
        dp.DataParallelTrainer(net, _mesh(), mode="hogwild")
    with pytest.raises(ValueError, match="pass mesh= or plan="):
        dp.DataParallelTrainer(net)
    # a plan with a model axis trains (tests/test_torch_tp_ranks.py holds
    # it to JAX's plan trainer at 4 ranks) and refuses what JAX's refuses
    from deeplearning4j_tpu_torch.parallel.plan import ShardPlan, plan_mesh

    plan = ShardPlan(mesh=plan_mesh({"batch": 1, "model": 1},
                                    device="cpu"))
    t = dp.DataParallelTrainer(net, plan=plan)
    assert t.tp is not None and np.isfinite(
        t.fit(_mlp_batches(1, n_in=4, n_out=2)))
    with pytest.raises(ValueError, match="mode='sync'"):
        dp.DataParallelTrainer(net, plan=plan, mode="averaging")
    with pytest.raises(ValueError, match="grad_accum"):
        dp.DataParallelTrainer(net, plan=plan, grad_accum=2)
    _, bn_net = _pair(_bn_conf())
    with pytest.raises(ValueError, match="BatchNorm"):
        dp.DataParallelTrainer(bn_net, plan=plan)


def test_mesh_of_one_rank_and_its_refusals():
    mesh = _mesh()
    assert mesh.shape == {"dp": 1} and mesh_axes(mesh) == ("dp",)
    assert make_mesh(device="cpu").shape == {"dp": 1}
    assert make_mesh({"dp": -1}, device="cpu").shape == {"dp": 1}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh({"dp": 2}, device="cpu")
    # every axis is ported; sizes that do not multiply to the group raise
    assert make_mesh({"dp": 1, "tp": 1}, device="cpu").shape == {
        "dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh({"dp": 1, "tp": 2}, device="cpu")
    x = np.arange(12, dtype=np.float64).reshape(6, 2)
    got = shard_batch(mesh, x)
    assert got.dtype == torch.float32 and got.shape == (6, 2)


@pytest.mark.parametrize("local_rank,cards,requested,want", [
    ("1", 2, None, "cuda:1"),
    ("1", 2, "cuda", "cuda:1"),
    # a rank shown only its own card
    ("3", 1, "cuda", "cuda:0"),
    ("1", 2, "cuda:0", "cuda:0"),
    ("1", 2, "cpu", "cpu"),
    # no torchrun: the current card
    (None, 2, "cuda", "cuda:0"),
])
def test_rank_device_is_the_card_of_torchruns_local_rank(
        monkeypatch, local_rank, cards, requested, want):
    """Under torchrun each rank takes the card of its LOCAL_RANK (one card
    a rank), not cuda:0 on every rank; an explicit device stands."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    if local_rank is not None:
        monkeypatch.setenv("RANK", local_rank)
        monkeypatch.setenv("WORLD_SIZE", "4")
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert rank_device(requested) == torch.device(want)


def test_trainer_refuses_a_network_off_its_mesh_device():
    _, net = _pair(jax_zoo.mlp(4, [8], 2))
    mesh = _mesh()
    card = Mesh(mesh.shape, mesh.group, torch.device("cuda", 1))
    with pytest.raises(ValueError, match="build the network on mesh.device"):
        dp.DataParallelTrainer(net, card)


def test_averaging_helpers_match_jax():
    a = {"W": np.ones((2, 2), np.float32), "b": np.zeros(2, np.float32)}
    b = {"W": 3 * np.ones((2, 2), np.float32),
         "b": 2 * np.ones(2, np.float32)}
    ta, tb = ({k: torch.from_numpy(v) for k, v in d.items()} for d in (a, b))
    _assert_trees(average_pytrees([ta, tb]),
                  jax_averaging.average_pytrees([a, b]), 0, 0)
    _assert_trees(merge(ta, tb, 3), jax_averaging.merge(a, b, 3), 0, 0)
    agg, jagg = ParameterAggregator(), jax_averaging.ParameterAggregator()
    for d, td in ((a, ta), (b, tb)):
        agg.accumulate(td)
        jagg.accumulate(d)
    _assert_trees(agg.aggregate(), jagg.aggregate(), 0, 0)
    assert agg.count == 2
    with pytest.raises(ValueError):
        average_pytrees([])


@pytest.mark.parametrize("asynchronous", [False, True])
def test_checkpoint_listener_kill_and_resume(tmp_path, asynchronous):
    """The JAX package's test_checkpoint_listener_kill_and_resume: the
    listener saves params, updater, step and the mesh record each
    iteration (the asynchronous writer from a snapshot taken at the
    iteration); a fresh trainer restores them bitwise and trains on."""
    conf = _with(jax_zoo.mlp(12, [16], 3), updater="adam", lr=0.01)
    ck = str(tmp_path / "auto")
    li = CheckpointListener(ck, save_every_n=1, asynchronous=asynchronous)
    _, net = _pair(conf)
    t1 = dp.DataParallelTrainer(net, _mesh(), listeners=[li])
    batches = _mlp_batches()
    for b in batches:
        t1.fit([b])
    li.wait()
    checkpoint.join_async()
    assert li.saves == 3
    _, meta = checkpoint.load(ck)[1:]
    assert meta["mesh"] == {"axis_names": ["dp"], "shape": {"dp": 1},
                            "zero1": False}
    _, net2 = _pair(conf, seed=9)
    t2 = dp.DataParallelTrainer(net2, _mesh())
    assert t2.restore(ck) == 3
    assert _states_equal(t1.state, t2.state)
    assert np.isfinite(t2.fit([batches[0]]))
    assert t2.state.step == 4
