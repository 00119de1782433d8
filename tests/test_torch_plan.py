"""The port's ShardPlan (`deeplearning4j_tpu_torch/parallel/plan.py`)
against the JAX package's: `parse_mesh_spec`, `plan_mesh`'s rank layout,
the cache-key surface, and the per-leaf specs of zoo trees."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax  # noqa: E402

from deeplearning4j_tpu.models import zoo as jax_zoo  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet  # noqa: E402,E501
from deeplearning4j_tpu.parallel import plan as jax_plan  # noqa: E402
from deeplearning4j_tpu_torch.parallel import plan  # noqa: E402
from deeplearning4j_tpu_torch.parallel.mesh import Mesh  # noqa: E402

SPECS = ["", "all", "batch=2", "batch=2,model=4", " model=-1 , batch=1",
         "batch=1,model=2,", "model=4"]
BAD = ["batch", "batch=x", "batch=0", "batch=-2", "batch=1,batch=2"]
LAYOUTS = [{"batch": 1}, {"batch": 4}, {"batch": 2, "model": 2},
           {"batch": 1, "model": 4}, {"batch": 4, "model": 1}]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_is_jaxs(spec):
    assert plan.parse_mesh_spec(spec) == jax_plan.parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", BAD)
def test_bad_mesh_specs_raise_jaxs_message(spec):
    with pytest.raises(ValueError) as want:
        jax_plan.parse_mesh_spec(spec)
    with pytest.raises(ValueError, match="bad mesh spec") as got:
        plan.parse_mesh_spec(spec)
    assert str(got.value) == str(want.value)


class _RankMesh(Mesh):
    """A Mesh whose rank is given (the layout's arithmetic alone)."""

    def __init__(self, shape, rank):
        super().__init__(shape, None, torch.device("cpu"))
        self._r = rank

    @property
    def rank(self):
        return self._r


def _jax_plan(shape):
    n = int(np.prod(list(shape.values())))
    return jax_plan.ShardPlan(mesh=jax_plan.plan_mesh(
        shape, devices=jax.devices()[:n]))


@pytest.mark.parametrize("shape", LAYOUTS, ids=str)
def test_rank_layout_is_jaxs_device_grid(shape):
    """Rank r sits where JAX's plan_mesh puts device r: batch outermost,
    model innermost (rank = b·M + m)."""
    jp = _jax_plan(shape)
    grid = np.vectorize(lambda d: d.id)(jp.mesh.devices)
    order = list(jp.mesh.axis_names)
    for r in range(grid.size):
        m = _RankMesh({a: int(jp.mesh.shape[a]) for a in order}, r)
        where = tuple(int(i) for i in np.argwhere(grid == grid.flat[r])[0])
        assert tuple(m.coord(a) for a in order) == where


def test_plan_mesh_over_one_rank():
    """At world size 1: {} is the 1-D batch mesh, batch comes first and
    defaults to 1, -1 fills, and a mesh needing more ranks raises."""
    assert plan.plan_mesh({}, device="cpu").shape == {"batch": 1}
    m = plan.plan_mesh({"model": -1}, device="cpu")
    assert m.axis_names == ("batch", "model")
    assert m.shape == {"batch": 1, "model": 1}
    assert m.axis_group("model") is m.group and m.coord("model") == 0
    with pytest.raises(ValueError, match="needs 2 ranks"):
        plan.plan_mesh({"batch": 1, "model": 2}, device="cpu")


@pytest.mark.parametrize("shape", [None] + LAYOUTS, ids=str)
@pytest.mark.parametrize("policy", ["f32", "bf16", "int8"])
def test_key_surface_is_jaxs(shape, policy):
    jp = (jax_plan.ShardPlan(policy=policy) if shape is None
          else jax_plan.ShardPlan(mesh=_jax_plan(shape).mesh, policy=policy))
    mesh = None if shape is None else types.SimpleNamespace(
        axis_names=tuple(jp.mesh.axis_names),
        shape={a: int(jp.mesh.shape[a]) for a in jp.mesh.axis_names})
    pp = plan.ShardPlan(mesh=mesh, policy=policy)
    for name in ("sharding_tag", "policy_suffix", "decode_tag",
                 "key_suffix", "decode_key_suffix", "fingerprint",
                 "describe"):
        assert getattr(pp, name)() == getattr(jp, name)(), name
    for name in ("axis_names", "has_model_axis", "model_size", "rows"):
        assert getattr(pp, name) == getattr(jp, name), name


def _zoo_params():
    confs = {"char_transformer": jax_zoo.char_transformer(
        16, d_model=32, n_blocks=2, n_heads=4, max_seq_len=8),
        "mlp": jax_zoo.mlp(12, [16, 6], 3),
        "char_lstm": jax_zoo.char_lstm(10, hidden=8, embed=8),
        "lenet5": jax_zoo.lenet5()}
    return {k: jax.device_get(JaxNet(c).init().params)
            for k, c in confs.items()}


ZOO = _zoo_params()


def _int8(tree):
    """The int8 policy's nesting: each 2-D weight as {"q", "scale"}."""
    return tuple({k: ({"q": a, "scale": a[:1]} if a.ndim == 2 else a)
                  for k, a in layer.items()} for layer in tree)


def _specs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_specs(tree):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)) and not (
                not t or t[0] is None or isinstance(t[0], str)):
            for x in t:
                walk(x)
        else:
            out.append(tuple(t))

    walk(tree)
    return out


@pytest.mark.parametrize("shape", [None] + LAYOUTS, ids=str)
@pytest.mark.parametrize("model", sorted(ZOO))
@pytest.mark.parametrize("fn", ["param_pspecs", "zero1_pspecs"])
def test_param_and_zero1_specs_are_jaxs(shape, model, fn):
    jp = (jax_plan.ShardPlan() if shape is None
          else jax_plan.ShardPlan(mesh=_jax_plan(shape).mesh))
    mesh = None if shape is None else types.SimpleNamespace(
        axis_names=tuple(jp.mesh.axis_names),
        shape={a: int(jp.mesh.shape[a]) for a in jp.mesh.axis_names})
    pp = plan.ShardPlan(mesh=mesh)
    for tree in (ZOO[model], _int8(ZOO[model])):
        want = _specs(getattr(jp, fn)(tree))
        got = _port_specs(getattr(pp, fn)(tree))
        assert got == want


@pytest.mark.parametrize("shape", LAYOUTS, ids=str)
def test_state_specs_are_jaxs(shape):
    """Decode state: dense and paged K/V tables and recurrent carries split
    their trailing dim by head where the model axis divides it."""
    state = ({"k": np.zeros((2, 16, 32)), "v": np.zeros((2, 16, 32)),
              "pos": np.zeros((2,))},
             {"k": np.zeros((6, 4, 32)), "v": np.zeros((6, 4, 32))},
             {"h": np.zeros((2, 12)), "c": np.zeros((2, 12)),
              "x": np.zeros((2, 8))})
    jp = jax_plan.ShardPlan(mesh=_jax_plan(shape).mesh)
    mesh = types.SimpleNamespace(
        axis_names=tuple(jp.mesh.axis_names),
        shape={a: int(jp.mesh.shape[a]) for a in jp.mesh.axis_names})
    got = _port_specs(plan.ShardPlan(mesh=mesh).state_pspecs(state))
    assert got == _specs(jp.state_pspecs(state))
