"""Layer-wise pretraining in the port vs the JAX package.

The random draws (`fold_in`, a Bernoulli of a tensor p, the one-key
categorical) bitwise; the RBM's units, Gibbs chain, CD-k gradient, score
and free energy, and the denoising autoencoder's loss and gradients, from
the same numpy params and keys (1e-6 for means, 1e-5 for gradients and
scores; the Gaussian and NReLU samples within erfinv's last place); the
zoo's DBN on Iris and deep autoencoder on 120 curves from JAX's initial
params and seed; the step cache's pretraining programs, checkpointed
`fit`, and the CLI recipes.

The DBN's and the deep autoencoder's finetunes are 60 and 100 iterations
of conjugate gradient. JAX's own run on inputs moved by 1e-7 relative
parts from its run by up to tens of percent of the score after a few dozen
iterations, so the finetuned params are not held to JAX's: the
pretrained layers are (1e-4 of max|leaf|), the first finetune iterations'
scores are (1e-5), a short finetune's params are (1e-4 of max|leaf|), and
the whole run's score gap to JAX stays within ten times JAX's own gap
under that perturbation; then JAX's own criteria (accuracy, MSE).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.cli.driver import main as jax_main  # noqa: E402
from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn import conf as jax_conf  # noqa: E402
from deeplearning4j_tpu.nn.layers import autoencoder as jax_ae  # noqa: E402
from deeplearning4j_tpu.nn.layers import rbm as jax_rbm  # noqa: E402
from deeplearning4j_tpu_torch.cli.driver import main  # noqa: E402
from deeplearning4j_tpu_torch.models import zoo  # noqa: E402
from deeplearning4j_tpu_torch.nd import random as nd_random  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as tconf  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers import autoencoder, rbm  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers import get_layer  # noqa: E402
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.reliability import TrainingInterrupted  # noqa: E402,E501

N_IN, N_OUT, B = 12, 8, 16
UNITS = ["binary", "gaussian", "rectified", "softmax"]


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, nd_random.key_array(np.asarray(k))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _layer(seed=0, n_in=N_IN, n_out=N_OUT):
    rng = np.random.RandomState(seed)
    p = {"W": (0.4 * rng.randn(n_in, n_out)).astype(np.float32),
         "b": (0.1 * rng.randn(n_out)).astype(np.float32),
         "vb": (0.1 * rng.randn(n_in)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _binary_x(seed=1, rows=B, n=N_IN):
    return (np.random.RandomState(seed).rand(rows, n) > 0.5).astype(
        np.float32)


def _confs(**kw):
    jc = jax_conf.NeuralNetConfiguration(n_in=N_IN, n_out=N_OUT, **kw)
    return jc, tconf.NeuralNetConfiguration(n_in=N_IN, n_out=N_OUT, **kw)


# --------------------------------------------------------------- the draws

@pytest.mark.parametrize("data", [0, 1, 2, 7, 123456, 2 ** 32 - 1])
def test_fold_in_is_jax_bitwise(data):
    k, tk = _key(42)
    np.testing.assert_array_equal(nd_random.fold_in(tk, data).numpy(),
                                  np.asarray(jax.random.fold_in(k, data)))


def test_bernoulli_of_a_tensor_p_and_the_one_key_categorical_are_jax():
    k, tk = _key(3)
    p = np.random.RandomState(0).rand(B, N_OUT).astype(np.float32)
    np.testing.assert_array_equal(
        nd_random.bernoulli(tk, torch.from_numpy(p)).numpy(),
        np.asarray(jax.random.bernoulli(k, jnp.asarray(p))))
    logits = np.random.RandomState(1).randn(B, 5).astype(np.float32)
    np.testing.assert_array_equal(
        nd_random.categorical_joint(tk, torch.from_numpy(logits)).numpy(),
        np.asarray(jax.random.categorical(k, jnp.asarray(logits), axis=-1)))


def _near_ties(tkey, p: np.ndarray) -> int:
    """Draws of a Bernoulli(p) whose uniform lies within 1e-6 of p: where
    a last-place difference in p can flip the sample."""
    u = nd_random.uniform(tkey, p.size).numpy().reshape(p.shape)
    return int((np.abs(u - p) < 1e-6).sum())


# ------------------------------------------------------------------ RBM

@pytest.mark.parametrize("unit", UNITS)
def test_rbm_unit_means_and_samples_match_jax(unit):
    k, tk = _key(5)
    pre = np.random.RandomState(2).randn(B, N_OUT).astype(np.float32)
    _close(rbm._unit_mean(unit, torch.from_numpy(pre)),
           jax_rbm._unit_mean(unit, jnp.asarray(pre)), 1e-6)
    got = _np(rbm._unit_sample(unit, tk, torch.from_numpy(pre)))
    want = np.asarray(jax_rbm._unit_sample(unit, k, jnp.asarray(pre)))
    if unit in ("binary", "softmax"):
        np.testing.assert_array_equal(got, want)
    else:
        # erfinv rounds in its own last place: a few 1e-7 relative
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("visible,hidden", [("binary", "binary"),
                                            ("gaussian", "rectified"),
                                            ("softmax", "binary")])
def test_rbm_propagation_gibbs_score_and_free_energy_match_jax(visible,
                                                              hidden):
    jc, tc = _confs(layer_type="rbm", visible_unit=visible,
                    hidden_unit=hidden, k=2)
    jp, tp = _layer()
    x = _binary_x()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    k, tk = _key(9)
    _close(rbm.RBM.prop_up(tp, tc, tx), jax_rbm.RBM.prop_up(jp, jc, jx),
           1e-6)
    _close(rbm.RBM.reconstruct(tp, tc, tx),
           jax_rbm.RBM.reconstruct(jp, jc, jx), 1e-6)
    v, h = rbm.RBM.gibbs(tp, tc, tk, tx, 2)
    jv, jh = jax_rbm.RBM.gibbs(jp, jc, k, jx, 2)
    # the first hidden sample's p, from the same key JAX folds in
    ties = _near_ties(nd_random.fold_in(tk, 0), np.asarray(
        jax.nn.sigmoid(jx @ jp["W"] + jp["b"])))
    if not np.allclose(_np(v), np.asarray(jv), rtol=1e-5, atol=1e-5):
        pytest.fail(f"Gibbs chain flipped; {ties} first-step draws lie "
                    f"within 1e-6 of p")
    _close(h, jh, 1e-5)
    _close(rbm.RBM.pretrain_score(tp, tc, tx, None),
           jax_rbm.RBM.pretrain_score(jp, jc, jx, None), 1e-5)
    _close(rbm.RBM.free_energy(tp, tc, tx),
           jax_rbm.RBM.free_energy(jp, jc, jx), 1e-5)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("extra", ["plain", "l2", "sparsity"])
def test_rbm_cd_gradient_and_score_match_jax(k, extra):
    kw = dict(layer_type="rbm", k=k)
    if extra == "l2":
        kw.update(use_regularization=True, l2=1e-2)
    elif extra == "sparsity":
        kw["sparsity"] = 0.1
    jc, tc = _confs(**kw)
    jp, tp = _layer(seed=3)
    x = _binary_x(seed=4)
    key, tkey = _key(11)
    jg, js = jax_rbm.RBM.pretrain_grad_and_score(jp, jc, jnp.asarray(x), key)
    tg, ts = rbm.RBM.pretrain_grad_and_score(tp, tc, torch.from_numpy(x),
                                             tkey)
    _close(ts, js, 1e-5)
    for name in ("W", "b", "vb"):
        _close(tg[name], jg[name], 1e-5)


# ----------------------------------------------------------- autoencoder

@pytest.mark.parametrize("corruption", [0.0, 0.3])
@pytest.mark.parametrize("extra", ["plain", "l2", "sparsity"])
def test_autoencoder_loss_and_gradients_match_jax(corruption, extra):
    kw = dict(layer_type="autoencoder", activation="sigmoid",
              corruption_level=corruption)
    if extra == "l2":
        kw.update(use_regularization=True, l2=1e-2)
    elif extra == "sparsity":
        kw["sparsity"] = 0.05
    jc, tc = _confs(**kw)
    jp, tp = _layer(seed=6)
    x = np.random.RandomState(7).rand(B, N_IN).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    key, tkey = _key(13)
    _close(autoencoder.AutoEncoder.encode(tp, tc, tx),
           jax_ae.AutoEncoder.encode(jp, jc, jx), 1e-6)
    _close(autoencoder.AutoEncoder.reconstruct(tp, tc, tx),
           jax_ae.AutoEncoder.reconstruct(jp, jc, jx), 1e-6)
    if corruption:
        np.testing.assert_array_equal(   # the corruption mask
            nd_random.binomial(tkey, 1.0 - corruption, x.shape).numpy(),
            np.asarray(jax.random.bernoulli(key, 1.0 - corruption,
                                            x.shape)).astype(np.float32))
    jg, js = jax_ae.AutoEncoder.pretrain_grad_and_score(jp, jc, jx, key)
    tg, ts = autoencoder.AutoEncoder.pretrain_grad_and_score(tp, tc, tx,
                                                             tkey)
    _close(ts, js, 1e-5)
    _close(autoencoder.AutoEncoder.pretrain_score(tp, tc, tx, tkey), js,
           1e-5)
    for name in ("W", "b", "vb"):
        _close(tg[name], jg[name], 1e-5)


def test_pretraining_layer_types_are_registered():
    assert get_layer("rbm") is rbm.RBM
    assert get_layer("autoencoder") is autoencoder.AutoEncoder
    assert get_layer("recursive_autoencoder") is autoencoder.AutoEncoder
    assert rbm.RBM.uses_key(None)
    assert not autoencoder.AutoEncoder.uses_key(
        tconf.NeuralNetConfiguration(corruption_level=0.0))


# ----------------------------------------------------------- the networks

def _iris01():
    from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher

    data = IrisDataFetcher().fetch(150)
    f = data.features
    f = (f - f.min(0)) / (f.max(0) - f.min(0) + 1e-6)
    return f.astype(np.float32), data.labels.astype(np.float32)


def _port_net(jnet, seed, device="cpu"):
    """A port network of JAX network `jnet`'s conf, made with `seed` as
    `jnet` was, on copies of its params."""
    net = ml.MultiLayerNetwork(
        tconf.MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device=device, seed=seed).init()
    net.params = checkpoint.params_from_numpy(jax.device_get(jnet.params),
                                              device)
    return net


def _leaf_gap(got, want) -> float:
    """max over leaves of |got - want| / max|want|."""
    out = 0.0
    for g, w in zip(got, want):
        for name in w:
            wa = np.asarray(w[name])
            scale = max(float(np.abs(wa).max()), 1e-12)
            out = max(out, float(np.abs(_np(g[name]) - wa).max()) / scale)
    return out


def _finetune_scores(jnet, x, y, perturb=0.0):
    """JAX's cached finetune scores from `jnet`'s params (not kept), with
    x moved by `perturb` relative, and the params it reaches."""
    if perturb:
        sign = np.random.RandomState(0).choice([-1.0, 1.0], x.shape)
        x = (x * (1 + perturb * sign)).astype(np.float32)
        y = x if y is None else y
    p, s = jnet.step_cache.finetune(jnet.conf, jnet.params, jnp.asarray(x),
                                    jnp.asarray(x if y is None else y),
                                    jax.random.PRNGKey(0))
    return np.asarray(s), p


def _check_finetune(net, jnet, x, y, first: int):
    """The port's cached finetune from JAX's params against JAX's: the
    first `first` scores within 1e-5, and every score's gap within ten
    times JAX's own gap under a 1e-7 relative move of x."""
    want, _ = _finetune_scores(jnet, x, y)
    own, _ = _finetune_scores(jnet, x, y, perturb=1e-7)
    net.params = checkpoint.params_from_numpy(jax.device_get(jnet.params),
                                              "cpu")
    tx = torch.from_numpy(x)
    got = net.step_cache.finetune(net.conf, net.params, tx,
                                  tx if y is None else torch.from_numpy(y))
    np.testing.assert_allclose(got[:first], want[:first], rtol=1e-5)
    gap = np.abs(got - want) / np.abs(want)
    own_gap = np.abs(own - want) / np.abs(want)
    assert gap.max() <= 10 * own_gap.max() + 1e-5, (gap.max(),
                                                     own_gap.max())


def test_dbn_on_iris_as_jax():
    """`zoo.dbn(4, [12, 8], 3)` on Iris in [0, 1]
    (tests/test_multilayer.py:137-152): pretraining from JAX's params and
    key stream, then the CG finetune from JAX's pretrained params."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    x, y = _iris01()
    jconf = jax_zoo.dbn(4, [12, 8], 3, iterations=30, finetune_iterations=60)
    assert zoo.dbn(4, [12, 8], 3).to_json() == jconf.to_json()
    jnet = JNet(jconf, seed=1).init()
    net = _port_net(jnet, 1)
    assert net._key == tuple(int(v) for v in jax.device_get(jnet._key))
    jnet.pretrain(x)
    net.pretrain(x)
    assert _leaf_gap(net.params, jax.device_get(jnet.params)) < 1e-4
    assert net._key == tuple(int(v) for v in jax.device_get(jnet._key))
    _check_finetune(net, jnet, x, y, first=20)
    # a 20-iteration finetune's params
    short = jax_zoo.dbn(4, [12, 8], 3, finetune_iterations=20)
    jshort = JNet(short, seed=1)
    jshort.params = jnet.params
    jp, _ = jshort.step_cache.finetune(short, jnet.params, jnp.asarray(x),
                                       jnp.asarray(y), jax.random.PRNGKey(0))
    tp = checkpoint.params_from_numpy(jax.device_get(jnet.params), "cpu")
    ml.MultiLayerNetwork(tconf.MultiLayerConfiguration.from_json(
        short.to_json()), device="cpu").step_cache.finetune(
        tconf.MultiLayerConfiguration.from_json(short.to_json()), tp,
        torch.from_numpy(x), torch.from_numpy(y))
    assert _leaf_gap(tp, jax.device_get(jp)) < 1e-4


def test_dbn_fit_trains_iris_and_keeps_jaxs_key_stream():
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    x, y = _iris01()
    jconf = jax_zoo.dbn(4, [12, 8], 3, iterations=30, finetune_iterations=60)
    jnet = JNet(jconf, seed=1).init()
    net = _port_net(jnet, 1)
    net.fit(x, y)
    jnet.fit(x, y)
    assert net._key == tuple(int(v) for v in jax.device_get(jnet._key))
    # JAX's criterion (tests/test_multilayer.py:150-152)
    acc = float((net.predict(x) == y.argmax(1)).mean())
    assert acc > 0.85, acc


def _curves(n=120):
    from deeplearning4j_tpu_torch.datasets.fetchers import CurvesDataFetcher

    return CurvesDataFetcher().fetch(n).features.astype(np.float32)


def test_deep_autoencoder_on_curves_as_jax(monkeypatch):
    """tests/test_multilayer.py:154-187: the denoising stack's
    pretraining and the unroll against JAX's, the finetune's scores, and
    JAX's reconstruction criteria."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    monkeypatch.delenv("CURVES_DIR", raising=False)
    monkeypatch.delenv("DL4J_CURVES_URL", raising=False)
    x = _curves()
    jconf = jax_zoo.deep_autoencoder(784, hidden=(64,), iterations=20,
                                     finetune_iterations=100, lr=0.1)
    jnet = JNet(jconf, seed=1).init()
    net = _port_net(jnet, 1)
    recon0 = net.output(x).numpy()
    mse0 = float(np.mean((recon0 - x) ** 2))
    jnet.pretrain(x)
    net.pretrain(x)
    assert _leaf_gap(net.params, jax.device_get(jnet.params)) < 1e-4
    jnet.params = jax_zoo.unroll_autoencoder_stack(jconf, jnet.params)
    _check_finetune(net, jnet, x, None, first=5)
    # the recipe end to end, from JAX's initial params
    jfull = JNet(jconf, seed=1).init()
    full = _port_net(jfull, 1)
    leaves = tree_leaves(full.params)
    zoo.fit_deep_autoencoder(full, x)
    assert all(a is b for a, b in zip(tree_leaves(full.params), leaves))
    recon = full.output(x).numpy()
    assert recon.shape == x.shape
    mse = float(np.mean((recon - x) ** 2))
    assert mse < 0.5 * float(np.var(x)), mse
    assert mse < 0.4 * mse0, (mse0, mse)


def test_unroll_transposes_the_encoder_and_empty_hidden_raises():
    """tests/test_multilayer.py:189-205."""
    conf = zoo.deep_autoencoder(12, hidden=(8, 4))
    net = ml.MultiLayerNetwork(conf, device="cpu", seed=0).init()
    params = zoo.unroll_autoencoder_stack(conf, net.params)
    torch.testing.assert_close(params[2]["W"], net.params[1]["W"].T)
    torch.testing.assert_close(params[2]["b"], net.params[1]["vb"])
    torch.testing.assert_close(params[3]["W"], net.params[0]["W"].T)
    assert params[0] is net.params[0]
    with pytest.raises(ValueError):
        zoo.deep_autoencoder(10, hidden=())


# ---------------------------------------- the step cache and checkpoints

def _small_dbn():
    return jax_zoo.dbn(n_in=6, hidden=[8, 4], n_out=3, iterations=2,
                       finetune_iterations=2)


def _small_data(n=16):
    rng = np.random.RandomState(0)
    x = rng.rand(n, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return x, y


def test_pretrain_programs_key_by_layer_and_hit_on_a_second_pass():
    """tests/test_step_cache.py:241-255, with JAX's cache keys."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    jnet = JNet(_small_dbn(), seed=0).init()
    net = _port_net(jnet, 0)
    x, y = _small_data()
    net.fit(x, y)
    jnet.fit(x, y)
    first = net.step_cache.stats.misses
    assert first == jnet.step_cache.stats.misses == 3
    assert (set(net.step_cache.stats.compile_seconds)
            == set(jnet.step_cache.stats.compile_seconds))
    net.fit(x, y)
    assert net.step_cache.stats.misses == first
    assert [k[:2] for k in net.step_cache.stats.compile_seconds][:2] == [
        ("pretrain", 0), ("pretrain", 1)]


@pytest.mark.parametrize("recipe", ["dbn", "deep_autoencoder"])
def test_cached_pretraining_equals_uncached_bitwise(recipe):
    conf = (zoo.dbn(6, [8, 4], 3, iterations=3, finetune_iterations=3)
            if recipe == "dbn" else
            zoo.deep_autoencoder(6, hidden=(5, 3), iterations=3,
                                 finetune_iterations=3))
    x, y = _small_data()
    nets = []
    for cached in (True, False):
        net = ml.MultiLayerNetwork(conf, device="cpu", seed=4).init()
        net.use_step_cache = cached
        net.fit(x, x if recipe == "deep_autoencoder" else y)
        nets.append(net)
    for a, b in zip(tree_leaves(nets[0].params), tree_leaves(nets[1].params)):
        assert torch.equal(a, b)
    assert nets[0]._key == nets[1]._key


def test_checkpointed_dbn_fit_stopped_and_resumed_equals_one_run(tmp_path):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    conf = tconf.MultiLayerConfiguration.from_json(_small_dbn().to_json())
    x, y = _small_data(24)
    batches = [DataSet(x[i:i + 8], y[i:i + 8]) for i in range(0, 24, 8)]
    ref = ml.MultiLayerNetwork(conf, device="cpu", seed=2).init()
    ref.fit(list(batches))

    class Stop:
        def iteration_done(self, model, iteration, score):
            model.request_stop_training()

    ck = str(tmp_path / "ck")
    first = ml.MultiLayerNetwork(conf, device="cpu", seed=2).init()
    first.set_listeners([Stop()])
    with pytest.raises(TrainingInterrupted):
        first.fit(list(batches), checkpoint_dir=ck)
    resumed = ml.MultiLayerNetwork(conf, device="cpu", seed=2).init()
    resumed.fit(list(batches), checkpoint_dir=ck)
    assert resumed.resumed_from_batch == 1
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(ref.params)):
        assert torch.equal(a, b)
    assert resumed._key == ref._key


def test_pretraining_params_round_trip_jaxs_checkpoint(tmp_path):
    """The RBM's and AE's `vb` leaves cross both ways under JAX's
    `arrays.npz` tree paths."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint

    for jconf in (_small_dbn(), jax_zoo.deep_autoencoder(6, hidden=(4,))):
        jnet = JNet(jconf, seed=5).init()
        jax_checkpoint.save(str(tmp_path / "j"), jnet.params, conf=jconf)
        net = checkpoint.load_network(str(tmp_path / "j"), device="cpu")
        assert _leaf_gap(net.params, jax.device_get(jnet.params)) == 0.0
        assert "vb" in net.params[0]
        checkpoint.save(str(tmp_path / "t"), net.params, conf=net.conf)
        back, _, _ = jax_checkpoint.load(str(tmp_path / "t"),
                                         like_params=jnet.params)
        assert _leaf_gap(net.params, jax.device_get(back)) == 0.0


# -------------------------------------------------------------------- CLI

def _last_json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


@pytest.mark.parametrize("spec,extra", [
    ("dbn:hidden=8x4", ["--scale-01"]),
    ("deep_autoencoder:hidden=3,iterations=3,finetune=5", ["--scale-01"])])
def test_cli_pretraining_recipes_train_with_jaxs_conf(tmp_path, capsys, spec,
                                                      extra):
    """`train --zoo dbn:hidden=8x4 --input iris:` (tests/test_cli.py:176)
    and the deep autoencoder: each trains, scores finitely, and writes
    JAX's conf.json; `--checkpoint-dir` exits as the JAX CLI does."""
    out = str(tmp_path / "t")
    argv = ["train", "--input", "iris:", "--zoo", spec, *extra]
    assert main(argv + ["--output", out, "--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert np.isfinite(got["score"])
    assert jax_main(argv + ["--output", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    assert (open(os.path.join(out, "conf.json")).read()
            == open(tmp_path / "j" / "conf.json").read())
    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    with pytest.raises(SystemExit, match="pretraining recipes") as ours:
        main(argv + ["--output", out, "--device", "cpu"] + ck)
    with pytest.raises(SystemExit) as theirs:
        jax_main(argv + ["--output", str(tmp_path / "j")] + ck)
    assert str(ours.value) == str(theirs.value)
