"""ShardPlan: how one model is laid out over a mesh of ranks.

Counterpart of `deeplearning4j_tpu/parallel/plan.py`. The JAX package's
plan names a `jax.sharding.Mesh` and derives a `PartitionSpec` for every
leaf, which GSPMD turns into collectives; the port's plan names a
`parallel.mesh.Mesh` of ranks (one process a rank) and keeps the same key
surface (`sharding_tag`, `policy_suffix`, `decode_tag`, `key_suffix`,
`fingerprint`, `describe`) and the same per-leaf specs (`param_pspecs`,
`state_pspecs`, `zero1_pspecs`), as tuples of axis names or None, one a
dim (`()` replicated, JAX's `P()`), equal to JAX's on the same trees.

The specs describe the JAX package's layout. The port's tensor-parallel
step lays the params out on its own (`parallel/tensor.py`,
`tp_layout`): the attention and FFN blocks split Megatron-style by head
and hidden unit, every other leaf whole on every rank (ROADMAP.md queue
C).

Axes: `batch` (rows of a batch; outermost) and `model` (the
tensor-parallel axis; innermost). `parse_mesh_spec` reads the CLI's
`--mesh` value and `plan_mesh` lays a parsed shape over the ranks of the
process group: rank = b·M + m on a {"batch": N, "model": M} mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

#: axis names of the plan's mesh
BATCH_AXIS = "batch"
MODEL_AXIS = "model"

#: the single-rank sharding tag (JAX's `InferCache.SINGLE`)
SINGLE = "single"

#: 2-D leaves whose first dim splits over `model` (row split): the
#: attention output and FFN down projections; other 2-D leaves split
#: their last dim where it divides
ROW_SPLIT_NAMES = frozenset({"Wo", "W2"})

#: decode-state leaves whose trailing dim splits over `model`
STATE_SPLIT_NAMES = frozenset({"k", "v", "h", "c"})


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """A `--mesh` value: "batch=2,model=4" -> {"batch": 2, "model": 4};
    "" and "all" (the bare flag) -> {}, the 1-D layout over every rank.
    Sizes may be -1 (every remaining rank, resolved by `plan_mesh`)."""
    spec = (spec or "").strip()
    if spec in ("", "all"):
        return {}
    shape: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected axis=N[,axis=N...] "
                f"(e.g. 'batch=2,model=4'), got segment {part!r}")
        axis, _, size = part.partition("=")
        axis = axis.strip()
        try:
            n = int(size)
        except ValueError:
            raise ValueError(f"bad mesh spec {spec!r}: size {size!r} of "
                             f"axis {axis!r} is not an integer") from None
        if n == 0 or n < -1:
            raise ValueError(f"bad mesh spec {spec!r}: axis {axis!r} "
                             f"size must be positive or -1, got {n}")
        if axis in shape:
            raise ValueError(f"bad mesh spec {spec!r}: axis {axis!r} "
                             f"given twice")
        shape[axis] = n
    return shape


def plan_mesh(shape: Optional[Dict[str, int]] = None, device=None,
              group=None):
    """The plan's mesh over the ranks of `group` (the default group):
    {} or None is the 1-D ("batch",) mesh over every rank; otherwise
    `batch` outermost (default 1) and the other axes after it in the
    order given, one of them possibly -1. The sizes must multiply to the
    group's size."""
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh, serve_mesh

    if not shape:
        return serve_mesh(device=device, group=group)
    shape = dict(shape)
    shape.setdefault(BATCH_AXIS, 1)
    axes = [BATCH_AXIS] + [a for a in shape if a != BATCH_AXIS]
    return make_mesh({a: shape[a] for a in axes}, device=device,
                     group=group, order=axes)


def _leaf_name(path: Tuple[str, ...]) -> str:
    """The name of a leaf: the last dict key on its path that is not a
    precision-policy wrapper key (int8 nests {"q", "scale"})."""
    for n in reversed(path):
        if n not in ("q", "scale"):
            return n
    return path[-1] if path else ""


def _map_named(fn, tree, path: Tuple[str, ...] = ()):
    """fn(name, leaf) over a tree of tuples, lists and dicts, keeping its
    structure; only dict keys name (sequence indices do not)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_named(fn, x, path) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(_leaf_name(path), tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in (getattr(leaf, "shape", ()) or ()))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How one model's programs are keyed and partitioned over a mesh of
    ranks (None: one rank)."""

    mesh: object = None
    policy: str = "f32"
    batch_axis: str = BATCH_AXIS
    model_axis: str = MODEL_AXIS

    # -- identity / cache keys ----------------------------------------------
    @property
    def axis_names(self) -> Tuple[str, ...]:
        return () if self.mesh is None else tuple(self.mesh.axis_names)

    @property
    def has_model_axis(self) -> bool:
        return self.model_axis in self.axis_names

    @property
    def model_size(self) -> int:
        if not self.has_model_axis:
            return 1
        return int(self.mesh.shape[self.model_axis])

    @property
    def batch_size(self) -> int:
        """The ranks a batch's rows split over (1 without a batch axis)."""
        if self.batch_axis not in self.axis_names:
            return 1
        return int(self.mesh.shape[self.batch_axis])

    @property
    def rows(self) -> int:
        """The row divisibility the plan asks of a batch: the batch axis's
        size (a 1-D mesh: every rank)."""
        if self.mesh is None:
            return 1
        if self.batch_axis in self.axis_names:
            return int(self.mesh.shape[self.batch_axis])
        n = 1
        for a in self.axis_names:
            n *= int(self.mesh.shape[a])
        return n

    def _dims(self) -> Tuple[int, ...]:
        return tuple(int(self.mesh.shape[a]) for a in self.axis_names)

    def sharding_tag(self):
        """The sharding element of a cache key (JAX's tag)."""
        if self.mesh is None:
            return SINGLE
        return ("mesh", self.axis_names, self._dims())

    def policy_suffix(self) -> Tuple:
        """The policy element(s) of a cache key: nothing for f32."""
        if self.policy == "f32":
            return ()
        return (("policy", self.policy),)

    def decode_tag(self):
        """The sharding element of decode keys: "single" unless the plan
        has a model axis."""
        return self.sharding_tag() if self.has_model_axis else SINGLE

    def key_suffix(self) -> Tuple:
        return (self.sharding_tag(),) + self.policy_suffix()

    def decode_key_suffix(self) -> Tuple:
        return (self.decode_tag(),) + self.policy_suffix()

    def fingerprint(self) -> str:
        return repr((self.sharding_tag(), self.policy))

    def describe(self) -> dict:
        if self.mesh is None:
            return {"axes": [], "shape": {}, "policy": self.policy}
        return {"axes": list(self.axis_names),
                "shape": {a: int(self.mesh.shape[a])
                          for a in self.axis_names},
                "policy": self.policy}

    # -- per-leaf specs (the JAX package's layout) ---------------------------
    def _param_spec(self, name: str, shape: Tuple[int, ...]) -> Tuple:
        m = self.model_size
        nd = len(shape)
        if m <= 1 or nd < 2:
            return ()
        if name in ROW_SPLIT_NAMES and shape[0] % m == 0:
            return (self.model_axis,) + (None,) * (nd - 1)
        if shape[-1] % m == 0:
            return (None,) * (nd - 1) + (self.model_axis,)
        if shape[0] % m == 0:
            return (self.model_axis,) + (None,) * (nd - 1)
        return ()

    def param_pspecs(self, params):
        """A spec a leaf of `params`, from its name and shape; without a
        model axis every leaf replicates (`()`)."""
        if not self.has_model_axis:
            return _map_named(lambda name, leaf: (), params)
        return _map_named(
            lambda name, leaf: self._param_spec(name, _shape(leaf)), params)

    def _state_spec(self, name: str, shape: Tuple[int, ...]) -> Tuple:
        m = self.model_size
        nd = len(shape)
        if (m <= 1 or nd < 2 or name not in STATE_SPLIT_NAMES
                or shape[-1] % m):
            return ()
        return (None,) * (nd - 1) + (self.model_axis,)

    def state_pspecs(self, state):
        """A spec a leaf of a decode-state tree: K/V tables and recurrent
        carries split their trailing dim over `model` where it divides."""
        if not self.has_model_axis:
            return _map_named(lambda name, leaf: (), state)
        return _map_named(
            lambda name, leaf: self._state_spec(name, _shape(leaf)), state)

    def zero1_pspecs(self, tree):
        """ZeRO-1 specs composed with the model axis: each leaf keeps its
        param spec and shards its first still-unsplit dim that the batch
        axis divides over the batch axis."""
        if self.mesh is None or self.batch_axis not in self.axis_names:
            return self.param_pspecs(tree)
        size = int(self.mesh.shape[self.batch_axis])

        def compose(name, leaf):
            shape = _shape(leaf)
            spec = (self._param_spec(name, shape) if self.has_model_axis
                    else ())
            parts = list(spec) + [None] * (len(shape) - len(spec))
            for d, dim in enumerate(shape):
                if parts[d] is None and dim % size == 0 and dim >= size:
                    parts[d] = self.batch_axis
                    return tuple(parts)
            return spec

        return _map_named(compose, tree)
