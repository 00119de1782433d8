"""The port's serve-precision policies against the JAX package's greedy
streams: the port's ContinuousBatcher under bf16 and int8 (JAX's int8
weights: one artifact), dense and paged, gives JAX's batcher's tokens, on
nets that learned a token cycle (a random net's near-uniform logits tie
within bfloat16's resolution). Served outputs are
`tests/test_torch_quantize.py`'s; the calibration and the error budgets
`tests/test_torch_budgets_*.py`'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet  # noqa: E402,E501
from deeplearning4j_tpu.optimize import quantize as jq  # noqa: E402
from deeplearning4j_tpu.serving.batcher import \
    ContinuousBatcher as JaxBatcher  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.optimize import quantize  # noqa: E402
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: E402
from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher  # noqa: E402,E501

def _pair(jconf, seed=0):
    """JAX's network and the port's on the CPU, the port's params carried
    over from JAX's."""
    jnet = JaxNet(jconf, seed=seed).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu", seed=seed)
    net.params = checkpoint.params_from_numpy(
        jax.device_get(jnet.params), "cpu")
    return jnet, net


def _set_policy(jnet, net, policy, clip=0.995):
    """Both networks under `policy`; int8 serves JAX's quantization at
    `clip` (packed by JAX, unpacked by the port: one artifact)."""
    if policy == "int8":
        jqp = jq.quantize_params_int8(jnet.params, clip)
        jnet.infer_cache.set_policy("int8", qparams=jqp)
        qparams, _ = quantize.unpack_quantized(jq.pack_quantized(jqp, {}),
                                               "cpu")
        net.infer_cache.set_policy("int8", qparams)
    else:
        jnet.set_serve_precision(policy, measure=False)
        net.set_serve_precision(policy, measure=False)


# -- generation ------------------------------------------------------------------

#: a token cycle the generation tests' nets learn, so that greedy choices
#: are decisive (a random net's near-uniform logits tie within bfloat16's
#: resolution, where XLA's CPU program keeps float32)
CYCLE = [1, 5, 9, 13, 17, 21, 2, 6, 10, 14]


def _trained_pair(kind):
    """JAX's network and the port's holding the port's params after a few
    steps on windows of CYCLE."""
    if kind == "char_transformer":
        jconf = jax_zoo.char_transformer(24, d_model=16, n_blocks=1,
                                         n_heads=2, max_seq_len=32, lr=0.05,
                                         iterations=30)
    else:
        jconf = jax_zoo.char_lstm(24, hidden=16, n_layers=1, embed=16,
                                  lr=1.0, iterations=40)
    jnet, net = _pair(jconf)
    ids = np.asarray([[CYCLE[(o + t) % len(CYCLE)] for t in range(13)]
                      for o in range(10)], np.int32)
    net.fit(ids[:, :-1], np.eye(24, dtype=np.float32)[ids[:, 1:].reshape(-1)])
    jnet.params = jax.tree_util.tree_map(
        jnp.asarray, checkpoint.params_to_numpy(net.params))
    return jnet, net


@pytest.mark.parametrize("policy", ["bf16", "int8"])
@pytest.mark.parametrize("kind", ["char_transformer", "char_lstm"])
def test_greedy_tokens_under_a_policy_are_jaxs(kind, policy):
    """Greedy streams of the port's ContinuousBatcher (dense table and,
    for the transformer, the paged pool) under bf16 and int8 (JAX's int8
    weights) equal JAX's batcher's, and continue the learned cycle."""
    jnet, net = _trained_pair(kind)
    _set_policy(jnet, net, policy)
    prompts = [[1, 5, 9], [13, 17, 21, 2]]
    options = [{}] + ([{"page_size": 8}] if kind == "char_transformer"
                      else [])
    for opts in options:
        streams = []
        for n, cls in ((jnet, JaxBatcher), (net, ContinuousBatcher)):
            n.warmup_generate(slots=2, max_seq=32, prompt_buckets=(8,),
                              **opts)
            cb = cls(n, n_slots=2, max_seq=32, prompt_buckets=(8,), **opts)
            try:
                ss = [cb.submit(p, max_new_tokens=10) for p in prompts]
                streams.append([list(s.tokens(timeout=120)) for s in ss])
            finally:
                cb.stop()
        assert streams[1] == streams[0], (opts, streams)
        start = CYCLE.index(prompts[0][-1]) + 1
        assert streams[1][0][:3] == [CYCLE[(start + i) % len(CYCLE)]
                                     for i in range(3)]
    assert all(k[-1] == ("policy", policy) for k in net.infer_cache._programs
               if k[0] != "output")
