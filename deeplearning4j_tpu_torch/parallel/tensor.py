"""Tensor parallelism over the model axis of a mesh: the Megatron splits.

The JAX package has no such module: GSPMD partitions its one program from
the plan's per-leaf specs and inserts the collectives. The port runs one
process a rank, so the collectives are explicit `torch.autograd.Function`s
over the model axis's process group (`mesh.axis_group("model")`):

  copy-to-model      identity forward, all-reduce of the gradient
  reduce-from-model  all-reduce forward, identity backward
  gather-from-model  all-gather forward (last dim), own slice backward

(`torch.distributed.nn.functional.all_reduce` all-reduces its gradient
too, which makes every model rank's gradient M times too large where each
computes the same loss.)

The layout (`tp_layout`): rank m of M holds the heads [m·H/M, (m+1)·H/M)
of every attention layer (those heads' columns in each of the q, k and v
thirds of `Wqkv` and `bqkv`, and their rows of `Wo`) and the hidden units
[m·F/M, (m+1)·F/M) of every transformer FFN (columns of `W1` and `b1`,
rows of `W2`); every other leaf (`bo`, `b2`, the layer norms, embedding,
positions, dense, output, LSTM, conv, RBM and autoencoder layers) is whole
on every rank, which computes the same values there. A split leaf's
local tensor is its pieces concatenated along the split dim (`pieces`:
the global bounds of each).

`TensorParallel` is what the layers see (`nn/layers/attention.py`,
`nn/multilayer.py` take it as the explicit argument `tp`): the group, M,
this rank's m, the split leaves, and the rows of the global batch this
rank holds, so that dropout draws the one mask of the global batch and
keeps its own rows.

The serving side: `ServeParallel` is the model axis of the inference
programs (`optimize/infer_cache.py`), where nothing is differentiated:
copy-to-model is the identity and reduce-from-model a plain in-place
all-reduce of the partial products, in the forward only.
`shard_params` cuts a network's whole params to this rank's layout (a
plan's `fit` leaves them whole, ROADMAP.md queue C, so serving shards them
again, as the JAX package's serving places them).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

#: collectives issued while a CUDA graph was being captured, by op: what a
#: captured step replays. (NCCL's in-place all-reduce over one rank moves
#: nothing and launches no kernel, so a profile of a world-size-1 replay
#: cannot show it.)
CAPTURED_COLLECTIVES = {"all_reduce": 0, "reduce_scatter": 0,
                        "all_gather": 0}


def _note(op: str, t: torch.Tensor) -> None:
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        CAPTURED_COLLECTIVES[op] += 1


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """SUM over `group`, in place; returns t."""
    import torch.distributed as dist

    _note("all_reduce", t)
    dist.all_reduce(t, group=group)
    return t


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    import torch.distributed as dist

    _note("reduce_scatter", out)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, inp, group=group)


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    import torch.distributed as dist

    _note("all_gather", out)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, inp, group=group)


# -- the collectives as autograd Functions ----------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.rank, ctx.width = rank, x.shape[-1]
        x = x.contiguous()
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        all_gather(out, x, group)
        return torch.cat(out.view((size,) + x.shape).unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width], None, None, None


def copy_to_model(x, group, size: int):
    return x if size == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x, group, size: int):
    return x if size == 1 else _ReduceFromModel.apply(x, group)


def gather_from_model(x, group, size: int, rank: int):
    return x if size == 1 else _GatherFromModel.apply(x, group, size, rank)


# -- the layout --------------------------------------------------------------

class Split(NamedTuple):
    """A split leaf: its dim and how many equal segments of it each rank
    takes a slice of (3 for the q, k, v thirds of `Wqkv` and `bqkv`)."""

    dim: int
    parts: int


#: the split leaves by layer type
SPLITS = {"attention": {"Wqkv": Split(1, 3), "bqkv": Split(0, 3),
                        "Wo": Split(0, 1)},
          "transformer_ffn": {"W1": Split(1, 1), "b1": Split(0, 1),
                              "W2": Split(0, 1)}}


def tp_layout(conf, size: int) -> Dict[Tuple[int, str], Split]:
    """{(layer, leaf name): Split} of `conf` over `size` model ranks; an
    attention layer's heads and an FFN's hidden width must divide."""
    out = {}
    for i, c in enumerate(conf.confs):
        kind = str(c.layer_type)
        if kind not in SPLITS:
            continue
        if kind == "attention" and c.n_heads % size:
            raise ValueError(f"layer {i}: {c.n_heads} heads do not divide "
                             f"over a model axis of {size}")
        if kind == "transformer_ffn":
            hid = c.ffn_hidden or 4 * c.n_in
            if hid % size:
                raise ValueError(f"layer {i}: FFN width {hid} does not "
                                 f"divide over a model axis of {size}")
        for name, split in SPLITS[kind].items():
            out[(i, name)] = split
    return out


def pieces(shape, split: Split, size: int, rank: int
           ) -> List[Tuple[Tuple[int, int], ...]]:
    """The global bounds ([start, end) a dim) of each piece of a split
    leaf that model rank `rank` of `size` holds, in the order they
    concatenate along `split.dim`."""
    seg = shape[split.dim] // split.parts
    w = seg // size
    out = []
    for p in range(split.parts):
        lo = p * seg + rank * w
        out.append(tuple((lo, lo + w) if d == split.dim else (0, int(n))
                         for d, n in enumerate(shape)))
    return out


def local_shape(shape, split: Split, size: int) -> Tuple[int, ...]:
    return tuple(n // size if d == split.dim else int(n)
                 for d, n in enumerate(shape))


def shard_leaf(whole, split: Optional[Split], size: int, rank: int):
    """This rank's local tensor (or array) of a whole leaf."""
    if split is None or size == 1:
        return whole
    parts = [whole[tuple(slice(lo, hi) for lo, hi in b)]
             for b in pieces(tuple(whole.shape), split, size, rank)]
    if isinstance(whole, torch.Tensor):
        return torch.cat(parts, dim=split.dim).contiguous()
    import numpy as np

    return np.ascontiguousarray(np.concatenate(parts, axis=split.dim))


def unshard_leaf(gathered: torch.Tensor, split: Split) -> torch.Tensor:
    """The whole leaf from every model rank's local tensor, stacked on a
    new leading dim in rank order."""
    size = gathered.shape[0]
    by_rank = [t.chunk(split.parts, dim=split.dim)
               for t in gathered.unbind(0)]
    return torch.cat([by_rank[r][p] for p in range(split.parts)
                      for r in range(size)], dim=split.dim)


class TensorParallel:
    """The model axis as the layers see it: `group`, `size` M, this
    rank's `rank` m, the `layout` of split leaves, and `rows`: (offset,
    local, total) of the global batch's feature rows this rank holds
    (None: all of them)."""

    def __init__(self, group, size: int, rank: int,
                 layout: Dict[Tuple[int, str], Split],
                 rows: Optional[Tuple[int, int, int]] = None):
        self.group, self.size, self.rank = group, int(size), int(rank)
        self.layout = layout
        self.rows = rows

    def with_rows(self, offset: int, local: int, total: int
                  ) -> "TensorParallel":
        if local == total:
            return TensorParallel(self.group, self.size, self.rank,
                                  self.layout)
        return TensorParallel(self.group, self.size, self.rank,
                              self.layout, (offset, local, total))

    def is_split(self, layer: int, name: str) -> bool:
        return self.size > 1 and (layer, name) in self.layout

    def copy_to_model(self, x):
        return copy_to_model(x, self.group, self.size)

    def reduce_from_model(self, x):
        return reduce_from_model(x, self.group, self.size)

    def gather_from_model(self, x):
        return gather_from_model(x, self.group, self.size, self.rank)

    def mask_rows(self, n: int) -> Optional[Tuple[int, int]]:
        """(offset, total) of a tensor of `n` leading rows within the
        global batch's (its rows are a whole multiple of the feature
        rows: B·T for a sequence model's flattened time), or None when
        this rank holds the whole batch."""
        if self.rows is None:
            return None
        offset, local, total = self.rows
        ratio = n // local
        return offset * ratio, total * ratio


class ServeParallel(TensorParallel):
    """The model axis of an inference program: no autograd, so the input
    needs no copy-to-model and the partial products are all-reduced in
    place (NCCL on the card, captured into the program's graph)."""

    def copy_to_model(self, x):
        return x

    def reduce_from_model(self, x):
        if self.size == 1:
            return x
        return all_reduce(x.contiguous(), self.group)


def serve_parallel(mesh, conf, axis: str = "model") -> ServeParallel:
    """The serving model axis of `mesh` for `conf`: its sub-group, size,
    this rank's coordinate and the layout (`tp_layout`)."""
    size = int(mesh.shape[axis])
    return ServeParallel(mesh.axis_group(axis), size, mesh.coord(axis),
                         tp_layout(conf, size))


def _shard_any(t, split: Optional[Split], size: int, rank: int):
    """`shard_leaf` of a leaf, or of an int8 serve leaf's {"q", "scale"}:
    `q` as its float leaf; its per-column `scale` ([1, n]) with the same
    pieces where the split is over the last dim (a column split), and
    whole where it is over the rows."""
    if not isinstance(t, dict):
        return shard_leaf(t, split, size, rank)
    q = t["q"]
    col = split is not None and split.dim == q.dim() - 1
    return {"q": shard_leaf(q, split, size, rank),
            "scale": shard_leaf(t["scale"], split if col else None, size,
                                rank)}


def shard_params(params, tp: TensorParallel):
    """This rank's params from a whole params tree: the split leaves of
    `tp.layout` cut to its slices (copies), every other leaf the whole
    tensor itself (shared, not copied). The int8 serve policy's quantized
    leaves split with their `q` (`_shard_any`)."""
    return tuple({name: _shard_any(t, tp.layout.get((i, name)), tp.size,
                                   tp.rank)
                  for name, t in layer.items()}
                 for i, layer in enumerate(params))
