"""Expert parallelism: Switch-style top-1 mixture-of-experts FFN.

Counterpart of `deeplearning4j_tpu/parallel/expert.py`: tokens route
top-1, pack into per-expert capacity buckets with one-hot einsums,
exchange with two all-to-alls, pass through the experts that live on
their rank, and come back weighted by the router's probability;
over-capacity tokens ride the residual. `moe_ffn_dense` is the one-rank
reference with the same routing.

The JAX package shards tokens and experts in one `shard_map`; the port
runs one process a rank: `moe_ffn` takes THIS rank's tokens [T/n, d] and
a params dict whose router is whole and whose W1, b1, W2, b2 are this
rank's n_experts/n experts. The router enters through copy-to (identity
forward, gradient all-reduced: the transpose of JAX's replicated
in-spec), the all-to-alls are their own transposes, and the routing
statistics `frac` and `mean_prob` are averaged over the ranks before
their product (an all-reduce whose backward is the identity), so the aux
loss is the dense global statistic. `init_moe_params` draws from the
port's own generator; carry JAX's params across to hold the two to one
start.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.parallel.tensor import (copy_to_model,
                                                      reduce_from_model)
from deeplearning4j_tpu_torch.reliability import faults


def init_moe_params(gen: torch.Generator, d_model: int, d_hidden: int,
                    n_experts: int, dtype=torch.float32) -> dict:
    """Router [d, E], W1 [E, d, h], b1 [E, h], W2 [E, h, d], b2 [E, d]:
    normals scaled by 1/sqrt(fan-in), zero biases, on `gen`'s device."""
    dev = gen.device
    s1, s2 = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_hidden)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    return {"router": normal(d_model, n_experts) * s1,
            "W1": normal(n_experts, d_model, d_hidden) * s1,
            "b1": torch.zeros((n_experts, d_hidden), dtype=dtype,
                              device=dev),
            "W2": normal(n_experts, d_hidden, d_model) * s2,
            "b2": torch.zeros((n_experts, d_model), dtype=dtype,
                              device=dev)}


def _route(params, x, capacity: int):
    """Top-1 routing with capacity buckets: x [T, d] -> (dispatch [T, E,
    C] one-hot, combine [T, E, C] gate-weighted, (frac [E], mean_prob
    [E]), the aux loss's statistics, unreduced)."""
    e = params["router"].shape[1]
    probs = torch.softmax(x @ params["router"], dim=-1)
    expert = torch.argmax(probs, dim=-1)
    onehot = F.one_hot(expert, e).to(x.dtype)
    gate = torch.sum(probs * onehot, dim=-1)
    # each token's place in its expert's bucket (0-based)
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot
    pos_tok = torch.sum(pos, dim=-1)
    keep = pos_tok < capacity
    slots = torch.arange(capacity, device=x.device, dtype=x.dtype)
    pos_oh = (pos_tok[:, None] == slots[None, :]).to(x.dtype)
    dispatch = (onehot[:, :, None] * pos_oh[:, None, :]
                * keep[:, None, None].to(x.dtype))
    combine = dispatch * gate[:, None, None]
    return dispatch, combine, (onehot.mean(dim=0), probs.mean(dim=0))


def _aux_loss(frac, mean_prob):
    return frac.shape[0] * torch.sum(frac * mean_prob)


def _expert_apply(w1, b1, w2, b2, xs):
    """xs: [E, G, C, d] token buckets (G = sender groups)."""
    h = F.gelu(torch.einsum("egcd,edh->egch", xs, w1)
               + b1[:, None, None, :], approximate="tanh")
    return torch.einsum("egch,ehd->egcd", h, w2) + b2[:, None, None, :]


def moe_ffn_dense(params, x, capacity_factor: float = 2.0):
    """The one-rank reference: x [T, d] -> ([T, d], aux_loss)."""
    t = x.shape[0]
    e = params["router"].shape[1]
    capacity = max(1, int(capacity_factor * t / e))
    dispatch, combine, (frac, mean_prob) = _route(params, x, capacity)
    aux = _aux_loss(frac, mean_prob)
    xs = torch.einsum("tec,td->ecd", dispatch, x)
    ys = _expert_apply(params["W1"], params["b1"], params["W2"],
                       params["b2"], xs[:, None])[:, 0]
    return x + torch.einsum("tec,ecd->td", combine, ys), aux


class _AllToAll(torch.autograd.Function):
    """x [n, ...]: slice j to rank j, rank j's slice for this rank back at
    j; its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def moe_ffn(params, x, mesh=None, axis: str = "ep",
            capacity_factor: float = 2.0, plan=None):
    """Expert-parallel MoE over this rank's tokens x [T/n, d] and its
    n_experts/n experts (module docstring). Returns ([T/n, d], aux_loss,
    the global statistic on every rank). mesh=None derives the mesh from
    `plan` or every rank (`pipeline.resolve_stage_mesh`)."""
    from deeplearning4j_tpu_torch.parallel.pipeline import resolve_stage_mesh

    mesh = resolve_stage_mesh(mesh, plan, axis)
    n = mesh.shape[axis]
    faults.fire("expert.dispatch", axis=axis, shards=int(n))
    group = mesh.axis_group(axis)
    e = params["router"].shape[1]
    if e % n:
        raise ValueError(f"n_experts={e} not divisible by {axis}={n}")
    e_loc = e // n
    if params["W1"].shape[0] != e_loc:
        raise ValueError(f"W1 holds {params['W1'].shape[0]} experts, this "
                         f"rank's share of {e} is {e_loc}")
    capacity = max(1, int(capacity_factor * x.shape[0] / e))
    router = copy_to_model(params["router"], group, n)
    dispatch, combine, (frac, mean_prob) = _route({"router": router}, x,
                                                  capacity)
    buckets = torch.einsum("tec,td->ecd", dispatch, x)
    buckets = buckets.reshape(n, e_loc, capacity, -1)
    # each peer its experts' buckets; [n (sender), e_loc, C, d] back
    recv = buckets if n == 1 else _AllToAll.apply(buckets, group)
    ys = _expert_apply(params["W1"], params["b1"], params["W2"],
                       params["b2"], recv.transpose(0, 1))
    # the results back to the tokens' ranks: [n (expert rank), e_loc, C, d]
    back = ys.transpose(0, 1)
    if n > 1:
        back = _AllToAll.apply(back, group)
    y = torch.einsum("tec,ecd->td", combine, back.reshape(e, capacity, -1))
    # the routing statistics made global before their product
    frac_g = reduce_from_model(frac, group, n) / n
    mean_prob_g = reduce_from_model(mean_prob, group, n) / n
    return x + y, _aux_loss(frac_g, mean_prob_g)
