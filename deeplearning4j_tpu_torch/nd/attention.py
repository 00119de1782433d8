"""Core attention math in plain PyTorch: full, and blockwise online-softmax.

Counterpart of `deeplearning4j_tpu/nd/attention.py`. Shapes are
[batch, seq, heads, head_dim], as in the JAX package. These are the plain
versions; the flash kernel is `nd/kernels.flash_attention`.
"""

from __future__ import annotations

import math

import torch

_NEG_BIG = -1e30  # finite -inf stand-in: keeps exp() NaN-free on masked rows


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[B,Sq,H,D] x [B,Sk,H,D] -> [B,H,Sq,Sk], scaled by sqrt(D) rounded to
    q's dtype. The rounding is done on the host, so that no host-to-device
    copy breaks a CUDA-graph capture."""
    d = q.shape[-1]
    return torch.einsum("bqhd,bkhd->bhqk", q, k) / float(
        torch.tensor(math.sqrt(d), dtype=q.dtype))


def _causal_mask(sq: int, sk: int, q_off: int, k_off: int, dtype,
                 device) -> torch.Tensor:
    """0 where key position k_off + j <= query position q_off + i, else
    -1e30: [sq, sk]."""
    qpos = q_off + torch.arange(sq, device=device)[:, None]
    kpos = k_off + torch.arange(sk, device=device)[None, :]
    return torch.zeros((sq, sk), dtype=dtype, device=device).masked_fill_(
        kpos > qpos, _NEG_BIG)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, q_offset: int = 0,
                   k_offset: int = 0) -> torch.Tensor:
    """Reference softmax attention (materializes the [Sq,Sk] scores); the
    offsets place q and k in a longer sequence for the causal mask."""
    s = _scores(q, k)
    if causal:
        s = s + _causal_mask(q.shape[1], k.shape[1], q_offset, k_offset,
                             s.dtype, s.device)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _online_update(o, m, l, q, kblk, vblk, q_off: int, k_off: int,
                   causal: bool):
    """One online-softmax step. o: [B,Sq,H,D] unnormalized output, m/l:
    [B,H,Sq] running max / denominator; q_off, k_off the global positions
    of q's and the block's first rows (for the causal mask)."""
    s = _scores(q, kblk)
    if causal:
        s = s + _causal_mask(q.shape[1], kblk.shape[1], q_off, k_off,
                             s.dtype, s.device)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha.permute(0, 2, 1)[..., None] \
        + torch.einsum("bhqk,bkhd->bqhd", p, vblk)
    return o_new, m_new, l_new


def _finalize(o, l):
    """The normalized output of an online softmax: o / l."""
    denom = l.permute(0, 2, 1)[..., None]
    return o / torch.clamp(denom, min=1e-30)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int = 512,
                        causal: bool = False) -> torch.Tensor:
    """Attention as a loop over KV blocks with online softmax; equal to
    `full_attention` without the full score matrix. A ragged tail is one
    short final block."""
    b, sk, h, d = k.shape
    sq = q.shape[1]
    block_size = min(block_size, sk)
    o = torch.zeros_like(q)
    m = torch.full((b, h, sq), _NEG_BIG, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, sq), dtype=q.dtype, device=q.device)
    for start in range(0, sk, block_size):
        stop = min(start + block_size, sk)
        o, m, l = _online_update(o, m, l, q, k[:, start:stop],
                                 v[:, start:stop], 0, start, causal)
    return _finalize(o, l)
