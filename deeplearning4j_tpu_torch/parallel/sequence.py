"""Sequence/context parallelism: ring and Ulysses (all-to-all) attention.

Counterpart of `deeplearning4j_tpu/parallel/sequence.py`. The JAX package
runs each as a `shard_map` over a mesh axis; the port runs one process a
rank, so the functions here take and return THIS rank's shard of the
sequence ([B, S/n, H, D], rank r holding positions [r·S/n, (r+1)·S/n) of
the axis's group) and their collectives are autograd Functions whose
backward is the transpose JAX's autodiff takes:

- `ring_attention`: each rank folds every visiting K/V block into its Q
  shard's online softmax (`nd/attention._online_update`, global positions
  for the causal mask; a block wholly in the future is skipped), the K/V
  pair rotating to the next rank after each block (`batch_isend_irecv`);
  the rotation's backward rotates dK/dV back.
- `ulysses_attention`: one `all_to_all_single` reshards seq-sharded to
  head-sharded, full attention runs over whole sequences locally, a second
  reshards back; heads % n must be 0.

The blocks are dense torch ops, as JAX's are einsums (no kernel).
"""

from __future__ import annotations

import functools

import torch

from deeplearning4j_tpu_torch.nd.attention import (  # noqa: F401
    _NEG_BIG, _finalize, _online_update, blockwise_attention, full_attention)


def _axis(mesh, axis: str):
    """(group, n, this rank's coordinate) of `axis` on `mesh`."""
    return mesh.axis_group(axis), mesh.shape[axis], mesh.coord(axis)


def _peer(group, r: int) -> int:
    import torch.distributed as dist

    return dist.get_global_rank(group, r) if group is not None else r


def _rotate(x: torch.Tensor, group, n: int, rank: int,
            back: bool = False) -> torch.Tensor:
    """x sent to the next rank of the ring (the previous one with
    `back`), the previous rank's (the next's) received."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    nxt, prv = (rank + 1) % n, (rank - 1) % n
    if back:
        nxt, prv = prv, nxt
    ops = [dist.P2POp(dist.isend, x, _peer(group, nxt), group),
           dist.P2POp(dist.irecv, out, _peer(group, prv), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    """One hop of the ring (JAX's `ppermute` to i + 1); its transpose is
    the hop back."""

    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.args = (group, n, rank)
        return _rotate(x, group, n, rank)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, *ctx.args, back=True), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "sp", causal: bool = False) -> torch.Tensor:
    """Ring attention over this rank's sequence shard: q, k, v [B, S/n, H,
    D] -> o [B, S/n, H, D], the rows `full_attention` of the whole
    sequence gives at these positions. K and V travel as one packed
    tensor, so each hop is one exchange a rank."""
    group, n, ai = _axis(mesh, axis)
    b, s_loc, h, _ = q.shape
    q_off = ai * s_loc
    kv = torch.stack([k, v])
    o = torch.zeros_like(q)
    m = torch.full((b, h, s_loc), _NEG_BIG, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=q.dtype, device=q.device)
    for r in range(n):
        src = (ai - r) % n
        # a block wholly in this shard's future contributes nothing
        if not (causal and src > ai):
            o, m, l = _online_update(o, m, l, q, kv[0], kv[1], q_off,
                                     src * s_loc, causal)
        if n > 1 and r < n - 1:
            kv = _Rotate.apply(kv, group, n, ai)
    out = _finalize(o, l)
    if causal and kv.requires_grad:
        # every rank's backward must take every hop back, also where its
        # last blocks were skipped: a zero term keeps the last one in the
        # graph
        out = out + 0.0 * kv.reshape(-1)[0]
    return out


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, S/n, H, D] seq-sharded -> [B, S, H/n, D] head-sharded."""
    import torch.distributed as dist

    send = torch.stack(x.chunk(n, dim=2)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=1)


def _heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, S, H/n, D] head-sharded -> [B, S/n, H, D] seq-sharded."""
    import torch.distributed as dist

    send = torch.stack(x.chunk(n, dim=1)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=2)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        return _seq_to_heads(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, *ctx.args), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        return _heads_to_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, *ctx.args), None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str = "sp",
                      causal: bool = False) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism over this
    rank's shard: reshard to whole sequences of H/n heads, full attention,
    reshard back. Requires heads % n == 0."""
    group, n, _ = _axis(mesh, axis)
    if q.shape[2] % n != 0:
        raise ValueError(f"heads ({q.shape[2]}) not divisible by {axis}={n}")
    if n == 1:
        return full_attention(q, k, v, causal=causal)
    qh, kh, vh = (_SeqToHeads.apply(t, group, n) for t in (q, k, v))
    return _HeadsToSeq.apply(full_attention(qh, kh, vh, causal=causal),
                             group, n)


def make_context_parallel_attention(mesh, axis: str = "sp",
                                    kind: str = "ring",
                                    causal: bool = False):
    """An attention closure over a fixed mesh: kind in {ring, ulysses}."""
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[kind]
    return functools.partial(fn, mesh=mesh, axis=axis, causal=causal)
