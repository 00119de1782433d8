"""Pipeline parallelism: GPipe-style microbatch pipelining over a mesh axis.

Counterpart of `deeplearning4j_tpu/parallel/pipeline.py`. The JAX package
runs the schedule as one `fori_loop` inside a `shard_map`, stage params
stacked on a leading axis sharded over `pp`; the port runs one process a
rank, each holding its own stage's params, and the same ticks: at tick t
stage s works on microbatch t − s (fill, steady state, drain), each hop
to the next stage an autograd Function (a send whose backward receives
the gradient back, a receive whose backward sends it), and the last
stage's outputs reach every rank through an all-reduce whose backward is
the identity, as JAX's `psum` of a replicated output transposes. A stage
works only on the ticks where it holds a microbatch (JAX's stages also
run `fn` on zeros there, which reaches no output). Stages must map an
activation to one of the same shape.
"""

from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch.optimize.tree import tree_leaves, tree_unflatten
from deeplearning4j_tpu_torch.parallel.tensor import reduce_from_model
from deeplearning4j_tpu_torch.reliability import faults


def resolve_stage_mesh(mesh, plan, axis: str):
    """The mesh a pipeline or expert stage runs on: an explicit mesh wins;
    a ShardPlan's mesh where it has `axis`, else a 1-axis mesh over its
    group; with neither, a 1-axis mesh over every rank of the default
    group."""
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    if mesh is not None:
        return mesh
    if plan is not None and plan.mesh is not None:
        if axis in plan.mesh.axis_names:
            return plan.mesh
        return make_mesh({axis: -1}, device=plan.mesh.device,
                         group=plan.mesh.group)
    return make_mesh({axis: -1})


class _Send(torch.autograd.Function):
    """Send x to global rank `dst`; returns a 0-d token that carries the
    backward: it receives x's gradient from `dst`."""

    @staticmethod
    def forward(ctx, x, dst, group, tag):
        import torch.distributed as dist

        ctx.args, ctx.like = (dst, group, tag), x
        dist.send(x.detach().contiguous(), dst=dst, group=group, tag=tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        import torch.distributed as dist

        dst, group, tag = ctx.args
        g = torch.empty_like(ctx.like, memory_format=torch.contiguous_format)
        dist.recv(g, src=dst, group=group, tag=tag)
        return g, None, None, None


class _Recv(torch.autograd.Function):
    """Receive an activation like `like` from global rank `src` (`anchor`
    a 0-d tensor that requires grad, so that the backward runs): its
    backward sends the gradient back to `src`."""

    @staticmethod
    def forward(ctx, anchor, like, src, group, tag):
        import torch.distributed as dist

        ctx.args = (src, group, tag)
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.recv(out, src=src, group=group, tag=tag)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        src, group, tag = ctx.args
        dist.send(g.contiguous(), dst=src, group=group, tag=tag)
        return None, None, None, None, None


def pipeline_apply(fn: Callable, stage_params, x_micro, mesh=None,
                   axis: str = "pp", plan=None):
    """Run microbatches through the stage pipeline.

    fn(params_one_stage, x) -> y with y.shape == x.shape. `stage_params`:
    THIS rank's stage (stage s = the rank's coordinate on `axis`).
    x_micro: [n_micro, mb, ...], the same on every rank. Returns [n_micro,
    mb, ...] outputs on every rank. mesh=None derives the mesh from
    `plan` or from every rank (`resolve_stage_mesh`)."""
    import torch.distributed as dist

    mesh = resolve_stage_mesh(mesh, plan, axis)
    n_stage = mesh.shape[axis]
    faults.fire("pipeline.stage", axis=axis, stages=int(n_stage))
    group, idx = mesh.axis_group(axis), mesh.coord(axis)
    n_micro = x_micro.shape[0]
    if n_stage == 1:
        return torch.stack([fn(stage_params, x_micro[i])
                            for i in range(n_micro)])
    peer = [dist.get_global_rank(group, s) for s in range(n_stage)]
    # the receives hang off a zero that depends on the stage's params, so
    # that a gradient taken for the params alone still runs their
    # backward (which the previous stage waits for)
    grads = [p for p in tree_leaves(stage_params)
             if isinstance(p, torch.Tensor) and p.requires_grad]
    token = (0.0 * grads[0].reshape(-1)[0] if grads
             else x_micro.new_zeros((), requires_grad=True))
    sent = x_micro.new_zeros(())
    outs = [torch.zeros_like(x_micro[0])] * n_micro
    for t in range(n_micro + n_stage - 1):
        mb = t - idx
        if not 0 <= mb < n_micro:
            continue
        if idx == 0:
            state = x_micro[mb]
        else:
            state = _Recv.apply(token, x_micro[0], peer[idx - 1], group, mb)
        y = fn(stage_params, state)
        if idx == n_stage - 1:
            outs[mb] = y
        else:
            sent = sent + _Send.apply(y, peer[idx + 1], group, mb)
    # only the last stage holds real outputs: replicate them (JAX's psum);
    # the tokens of the sends join the graph here, with a zero value
    out = torch.stack(outs) + sent.to(x_micro.dtype)
    return reduce_from_model(out, group, n_stage)


def make_pipeline_train_step(fn: Callable, loss_fn: Callable, mesh=None,
                             axis: str = "pp", lr: float = 0.1, plan=None):
    """SGD train step over the pipeline: step(params, x_micro, y_micro) ->
    (this stage's new params, loss). The gradients flow back through the
    hops (GPipe backward), then each stage updates its own params."""
    mesh = resolve_stage_mesh(mesh, plan, axis)

    def step(params, x_micro, y_micro):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        loss = loss_fn(pipeline_apply(fn, p, x_micro, mesh, axis), y_micro)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new = [a - lr * g for a, g in zip(leaves, grads)]
        return tree_unflatten(params, new), loss.detach()

    return step
