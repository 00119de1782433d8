"""The port's layers, network and checkpoint reading vs the JAX package.

A small charTransformer (vocab 24, d_model 16, 1 block, 2 heads, seq 16)
with `attention_impl="flash"` is built in both packages from one conf JSON.
Its params are drawn with numpy from a seed and carried across with
`params_from_numpy`; the JAX flash kernel runs in interpret mode. f32 is
held at 1e-4, bf16 compute at 2e-2.
"""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nd.ops import activate as jax_activate  # noqa: E402
from deeplearning4j_tpu.nn import multilayer as jax_ml  # noqa: E402
from deeplearning4j_tpu.nn.layers import get_layer as jax_get_layer  # noqa: E402,E501
from deeplearning4j_tpu.nn.layers.preprocessor import (  # noqa: E402
    apply_preprocessor as jax_preprocess)
from deeplearning4j_tpu.parallel import checkpoint as jax_checkpoint  # noqa: E402,E501
from deeplearning4j_tpu_torch.nd.ops import Activation, activate  # noqa: E402
from deeplearning4j_tpu_torch.nn import multilayer as ml  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    LayerType, MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.layers import get_layer  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers.preprocessor import (  # noqa: E402
    apply_preprocessor)
from deeplearning4j_tpu_torch.parallel.checkpoint import (  # noqa: E402
    load_network, params_from_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, ROWS, SEQ = 24, 2, 8
TOL = {"": 1e-4, "bfloat16": 2e-2}


def _confs(compute_dtype=""):
    """(JAX conf, port conf) of the small flash charTransformer."""
    jconf = jax_zoo.char_transformer(VOCAB, d_model=16, n_blocks=1,
                                     n_heads=2, max_seq_len=16)
    jconf = jconf.replace(confs=tuple(c.replace(attention_impl="flash")
                                      for c in jconf.confs))
    if compute_dtype:
        jconf = jconf.with_compute_dtype(compute_dtype)
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _numpy_params(jconf, seed=0):
    """JAX-shaped params with every leaf drawn from a numpy seed (nonzero
    biases, perturbed layer-norm gains) so each term is exercised."""
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax_ml.init_params(jconf, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(seed)
    out = []
    for layer in shapes:
        d = {}
        for name, shape in layer.items():
            x = rng.standard_normal(shape).astype(np.float32)
            d[name] = (1.0 + 0.1 * x if name == "ln_g"
                       else (0.3 if len(shape) == 2 else 0.1) * x)
        out.append(d)
    return tuple(out)


def _ids(seed=1, rows=ROWS):
    return np.random.RandomState(seed).randint(0, VOCAB, (rows, SEQ))


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", [a.value for a in Activation])
def test_activations_match_jax(name):
    x = np.linspace(-3.0, 3.0, 24, dtype=np.float32).reshape(2, 12)
    np.testing.assert_allclose(activate(name, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_activate(name, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("compute_dtype", ["", "bfloat16"])
@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_each_layer_matches_jax(index, compute_dtype):
    jconf, tconf = _confs(compute_dtype)
    np_params = _numpy_params(jconf)
    rng = np.random.RandomState(2)
    x = (_ids() if index == 0
         else rng.standard_normal((ROWS, SEQ, 16)).astype(np.float32))
    jc, tc = jconf.conf(index), tconf.conf(index)
    jx = jax_preprocess(jconf.preprocessor(index), jnp.asarray(x))
    tx = apply_preprocessor(tconf.preprocessor(index), torch.from_numpy(x))
    want = jax_get_layer(jc.layer_type).forward(
        jax.tree_util.tree_map(jnp.asarray, np_params[index]), jc, jx)
    got = get_layer(tc.layer_type).forward(
        params_from_numpy(np_params, "cpu")[index], tc, tx)
    assert tuple(got.shape) == tuple(want.shape)
    _assert_close(got, want, TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", ["", "bfloat16"])
def test_network_output_matches_jax(compute_dtype):
    jconf, tconf = _confs(compute_dtype)
    np_params = _numpy_params(jconf, seed=3)
    x = _ids(seed=4)
    want = jax_ml.network_output(
        jconf, jax.tree_util.tree_map(jnp.asarray, np_params),
        jnp.asarray(x))
    net = ml.MultiLayerNetwork(tconf, device="cpu")
    net.params = params_from_numpy(np_params, "cpu")
    got = net.output(x)
    assert tuple(got.shape) == (ROWS * SEQ, VOCAB)
    _assert_close(got, want, TOL[compute_dtype])
    np.testing.assert_array_equal(net.predict(x), got.argmax(-1).numpy())
    # the logits too: softmax probabilities over 24 classes are about 0.04
    # each, so the tolerance on them alone would let a large error through
    last = tconf.n_layers - 1
    jacts = jax_ml.feed_forward(
        jconf, jax.tree_util.tree_map(jnp.asarray, np_params),
        jnp.asarray(x))
    want_z = jax_get_layer(LayerType.OUTPUT).preout(
        jax.tree_util.tree_map(jnp.asarray, np_params[last]),
        jconf.conf(last), jax_preprocess(jconf.preprocessor(last),
                                         jacts[-2]))
    tacts = ml.feed_forward(tconf, net.params, torch.from_numpy(x))
    got_z = get_layer(LayerType.OUTPUT).preout(
        net.params[last], tconf.conf(last),
        apply_preprocessor(tconf.preprocessor(last), tacts[-2]))
    assert tuple(got_z.shape) == (ROWS * SEQ, VOCAB)
    _assert_close(got_z, want_z, TOL[compute_dtype])


@pytest.mark.parametrize("impl", ["auto", "full", "blockwise"])
def test_plain_attention_impls_match_flash_on_cpu(impl):
    jconf, tconf = _confs()
    params = params_from_numpy(_numpy_params(jconf, seed=5), "cpu")
    plain = tconf.replace(confs=tuple(
        c.replace(attention_impl=impl, attention_block_size=4)
        for c in tconf.confs))
    x = torch.from_numpy(_ids(seed=6))
    _assert_close(ml.network_output(plain, params, x),
                  ml.network_output(tconf, params, x).numpy(), 1e-5)


@pytest.mark.parametrize("model", ["char_transformer", "lenet5", "mlp",
                                   "vgg_cifar10"])
def test_conf_json_round_trips_through_the_port(model):
    if model == "char_transformer":
        jconf = _confs("bfloat16")[0]
    elif model == "mlp":
        jconf = jax_zoo.mlp(8, [16, 16], 3)
    else:
        jconf = getattr(jax_zoo, model)()
    text = jconf.to_json()
    assert MultiLayerConfiguration.from_json(text).to_json() == text


def test_conf_from_json_drops_unknown_keys():
    import json

    d = json.loads(_confs()[0].to_json())
    d["confs"][0]["no_such_field"] = 1
    conf = MultiLayerConfiguration.from_json(json.dumps(d))
    assert conf.conf(0).n_in == VOCAB


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jconf, _ = _confs()
    jparams = jax.tree_util.tree_map(jnp.asarray, _numpy_params(jconf, 7))
    jax_checkpoint.save(str(tmp_path / "ckpt"), jparams, conf=jconf)
    net = load_network(str(tmp_path / "ckpt"), device="cpu")
    x = _ids(seed=8)
    want = jax_ml.network_output(jconf, jparams, jnp.asarray(x))
    _assert_close(net.output(x), want, 1e-4)
    assert [sorted(p) for p in net.params] == [sorted(p) for p in jparams]


def test_port_init_draws_params_of_the_jax_shapes():
    jconf, tconf = _confs()
    jparams = jax_ml.init_params(jconf, jax.random.PRNGKey(0))
    net = ml.MultiLayerNetwork(tconf, device="cpu", seed=0).init()
    for jp, tp in zip(jparams, net.params):
        assert {k: tuple(v.shape) for k, v in jp.items()} == \
            {k: tuple(v.shape) for k, v in tp.items()}
    again = ml.MultiLayerNetwork(tconf, device="cpu", seed=0).init()
    for a, b in zip(net.params, again.params):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_embedding_rejects_sequences_past_max_seq_len():
    _, tconf = _confs()
    net = ml.MultiLayerNetwork(tconf, device="cpu").init()
    with pytest.raises(ValueError, match="max_seq_len"):
        net.output(np.zeros((1, 17), np.int64))


@pytest.mark.parametrize("bad_id", [VOCAB, 300, -1])
def test_embedding_rejects_ids_outside_the_vocabulary(bad_id):
    _, tconf = _confs()
    net = ml.MultiLayerNetwork(tconf, device="cpu").init()
    x = _ids(seed=9)
    x[0, 2] = bad_id
    with pytest.raises(ValueError, match=r"token ids must lie in \[0, 24\)"):
        net.check_input(x)
    with pytest.raises(ValueError, match="token ids"):
        net.output(x)
    net.check_input(_ids(seed=9))


def test_conv_and_pretraining_layer_types_are_registered():
    """The conv-net layers are ported (CONVOLUTION raised naming item 9
    before), and so are the pretraining layers (RBM raised naming item 9
    before; tests/test_torch_pretrain.py holds them to JAX)."""
    from deeplearning4j_tpu_torch.nn.layers import (autoencoder, base, conv,
                                                    rbm)

    assert get_layer(LayerType.CONVOLUTION) is conv.ConvolutionLayer
    assert get_layer("subsampling") is conv.SubsamplingLayer
    assert get_layer(LayerType.BATCH_NORM) is base.BatchNormLayer
    assert get_layer(LayerType.RBM) is rbm.RBM
    assert get_layer(LayerType.AUTOENCODER) is autoencoder.AutoEncoder


def test_lstm_layer_types_are_registered():
    from deeplearning4j_tpu_torch.nn.layers.lstm import (GravesLSTMLayer,
                                                         LSTMLayer)

    assert get_layer(LayerType.LSTM) is LSTMLayer
    assert get_layer("graves_lstm") is GravesLSTMLayer


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch,
                                                             tmp_path):
    from deeplearning4j_tpu_torch.cli.driver import main as cli_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jconf, tconf = _confs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ml.MultiLayerNetwork(tconf)
    jax_checkpoint.save(str(tmp_path / "ckpt"),
                        jax_ml.init_params(jconf, jax.random.PRNGKey(0)),
                        conf=jconf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_network(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["serve", "--model", str(tmp_path / "ckpt")])
    text = tmp_path / "corpus.txt"
    text.write_text("the lazy dog reads code " * 4)
    data = ["--input", f"text:{text}:8"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["train", *data, "--zoo", "char_lstm:hidden=8",
                  "--output", str(tmp_path / "lstm")])
    cli_main(["train", *data, "--zoo", "char_lstm:hidden=8", "--output",
              str(tmp_path / "lstm"), "--device", "cpu"])
    for cmd in ("predict", "test"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli_main([cmd, *data, "--model", str(tmp_path / "lstm")])
        cli_main([cmd, *data, "--model", str(tmp_path / "lstm"), "--device",
                  "cpu"])
    assert ml.MultiLayerNetwork(tconf, device="cpu").device.type == "cpu"


def _port_sources():
    pkg = os.path.join(REPO, "deeplearning4j_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = {"jax", "jaxlib", "deeplearning4j_tpu"}
    found = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [(path, n) for n in names if n.split(".")[0] in banned]
    assert found == []
