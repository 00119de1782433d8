"""Multi-head self-attention and the transformer FFN.

Counterpart of `deeplearning4j_tpu/nn/layers/attention.py`: the forward
pass, and the attention layer's `prefill`, `decode_step`,
`decode_step_paged` and the `verify_chunk`/`verify_chunk_paged` of
speculative decoding (a decode step is a verify chunk of one token).
Every one of them takes the model axis (`tp`,
`parallel/tensor.TensorParallel`): the params then hold this rank's H/M
heads, its K/V rows are those heads' n/M columns (contiguous, as heads are
laid out head-major), and the partial output projection is summed over the
model group before `bo` is added. Input
and output are [batch, seq, n_in]; params are {"Wqkv", "bqkv", "Wo", "bo",
"ln_g", "ln_b"} and {"W1", "b1", "W2", "b2", "ln_g", "ln_b"}, as in the
JAX package. Under training with a key, both layers drop their branch's
output (`conf.dropout`) before the residual add, with JAX's masks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nd import kernels
from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nd.attention import (_NEG_BIG,
                                                   blockwise_attention,
                                                   full_attention)
from deeplearning4j_tpu_torch.nn.layers.base import (_sampler, compute_dtype,
                                                     mixed_matmul,
                                                     param_dtype)
from deeplearning4j_tpu_torch.nn.weights import init_weights


def _layer_norm(x, g, b, eps: float = 1e-5):
    """Layer norm over the last axis with the population variance."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _dropped(conf, o, key, training, tp=None):
    """The branch output `o` with dropout under training, as the JAX
    package applies it before the residual add (under a batch split, the
    global batch's mask cut to this rank's rows)."""
    if training and conf.dropout > 0.0 and key is not None:
        o = o * nd_random.dropout_mask(
            key, 1.0 - conf.dropout, o.shape, o.dtype,
            rows=None if tp is None else tp.mask_rows(o.shape[0]))
    return o


def _vector(n, fill, conf, device):
    return torch.full((n,), fill, dtype=param_dtype(conf), device=device)


class MultiHeadAttentionLayer:
    """Pre-LN multi-head self-attention with a residual connection."""

    @staticmethod
    def init(key, conf):
        n = conf.n_in
        kq, ko = nd_random.split(key)
        if n % conf.n_heads != 0:
            raise ValueError(f"n_in={n} not divisible by "
                             f"n_heads={conf.n_heads}")
        if conf.n_out not in (0, n):
            raise ValueError(
                f"attention is residual: n_out must equal n_in={n} (or 0), "
                f"got {conf.n_out}")
        d, dev = param_dtype(conf), key.device
        return {
            "Wqkv": init_weights(kq, (n, 3 * n), conf.weight_init,
                                 _sampler(conf), d),
            "bqkv": _vector(3 * n, 0.0, conf, dev),
            "Wo": init_weights(ko, (n, n), conf.weight_init, _sampler(conf),
                               d),
            "bo": _vector(n, 0.0, conf, dev),
            "ln_g": _vector(n, 1.0, conf, dev),
            "ln_b": _vector(n, 0.0, conf, dev),
        }

    @staticmethod
    def forward(params, conf, x, key=None, training=False, tp=None):
        """Under a model axis (`tp`, `parallel/tensor.TensorParallel`) the
        params hold this rank's H/M heads (`tp_layout`): the input enters
        through copy-to-model, the heads attend on their own, and the
        partial output projection is summed over the model group before
        `bo` is added once."""
        b, s, n = x.shape
        h = conf.n_heads
        hd = n // h
        xn = _layer_norm(x, params["ln_g"], params["ln_b"])
        if tp is not None:
            xn = tp.copy_to_model(xn)
            h //= tp.size
        # the projections and the attention run in compute_dtype; the
        # residual stream and the layer norm stay in the param dtype
        qkv = (mixed_matmul(xn, params["Wqkv"], conf)
               + params["bqkv"]).to(compute_dtype(conf))
        # views of the fused projection: the kernel reads them in place
        q, k, v = (t.view(b, s, h, hd) for t in qkv.split(h * hd, dim=-1))
        o = MultiHeadAttentionLayer._attend(conf, q, k, v)
        o = mixed_matmul(o.reshape(b, s, h * hd).to(x.dtype), params["Wo"],
                         conf)
        if tp is not None:
            o = tp.reduce_from_model(o)
        o = o + params["bo"]
        return x + _dropped(conf, o, key, training, tp)

    @staticmethod
    def _out(params, conf, x, o, tp):
        """x + the output projection of the heads' rows `o` (this rank's
        under `tp`, whose partial products the model group sums before
        `bo`)."""
        o = mixed_matmul(o.to(x.dtype), params["Wo"], conf)
        if tp is not None:
            o = tp.reduce_from_model(o)
        return x + (o + params["bo"])

    @staticmethod
    def prefill(params, conf, x, k_cache, v_cache, tp=None):
        """The prompt phase of KV-cache generation: the forward over the
        whole prompt (the same `_attend`, so on CUDA the flash kernel), with
        the projected K/V rows written into the caches in place.

        x: [B, T, n]; caches: [B, max_S, w] (T <= max_S), w = n, or n/M
        under a model axis of M (this rank's heads' columns). Returns
        (hidden [B, T, n], k_cache, v_cache). Bucket padding writes junk
        K/V at positions >= length, which nothing reads: the causal mask
        hides it from the prompt, and `decode_step` writes position `pos`
        before it attends to it."""
        b, s, n = x.shape
        hd = n // conf.n_heads
        q, k, v = MultiHeadAttentionLayer._decode_qkv(params, conf, x)
        k_cache[:, :s].copy_(k)
        v_cache[:, :s].copy_(v)
        o = MultiHeadAttentionLayer._attend(
            conf, *(t.view(b, s, -1, hd) for t in (q, k, v)))
        o = MultiHeadAttentionLayer._out(params, conf, x,
                                         o.reshape(b, s, -1), tp)
        return o, k_cache, v_cache

    @staticmethod
    def _decode_qkv(params, conf, x):
        """The q, k, v rows of the tokens `x` ([..., w] each, compute
        dtype; w = n, or this rank's heads' n/M under a model axis)."""
        xn = _layer_norm(x, params["ln_g"], params["ln_b"])
        qkv = (mixed_matmul(xn, params["Wqkv"], conf)
               + params["bqkv"]).to(compute_dtype(conf))
        return qkv.split(params["Wqkv"].shape[-1] // 3, dim=-1)

    @staticmethod
    def _decode_attend(params, conf, x, q, k_ctx, v_ctx, idx, tp=None):
        """The attention of K tokens a row over the row's context and the
        output projection: x [B, K, n], q [B, K, w]; k_ctx, v_ctx
        [B, ctx, w], the row's K/V rows by position (w = n, or n/M under a
        model axis); idx [B, K], each token's position.
        Scores are [B, H, K, ctx], one sequence-long axis, and token i sees
        key positions <= idx[:, i] (the additive -1e30 mask of
        `nd.attention.full_attention`, as in the JAX package), so a chunk's
        rows are those of K one-token steps."""
        b, kk, n = x.shape
        hd = n // conf.n_heads
        h = q.shape[-1] // hd
        cd = compute_dtype(conf)
        ctx = k_ctx.shape[1]
        qh = q.reshape(b, kk, h, hd).transpose(1, 2)
        kh = k_ctx.to(cd).view(b, ctx, h, hd)
        vh = v_ctx.to(cd).view(b, ctx, h, hd)
        # one batched product over the heads a row: a row's K^T
        # [h, hd, ctx] and V [h, ctx, hd] are strided views of its rows
        # that cuBLAS reads in place, where one product over (b, h) would
        # first copy the whole context
        s = torch.stack([torch.bmm(qh[i], kh[i].permute(1, 2, 0))
                         for i in range(b)]) / float(
            torch.tensor(math.sqrt(hd), dtype=cd))
        kpos = torch.arange(ctx, device=x.device)[None, None, :]
        mask = torch.where(kpos <= idx.long()[:, :, None], 0.0,
                           _NEG_BIG).to(s.dtype)
        p = torch.softmax(s + mask[:, None], dim=-1)
        o = torch.stack([torch.bmm(p[i], vh[i].permute(1, 0, 2))
                         for i in range(b)])
        return MultiHeadAttentionLayer._out(
            params, conf, x, o.transpose(1, 2).reshape(b, kk, h * hd), tp)

    @staticmethod
    def decode_step(params, conf, x, k_cache, v_cache, pos, tp=None):
        """One generated token against the KV cache: `verify_chunk` of one
        token.

        x: [B, n], the current token's hidden row; caches: [B, max_S, n];
        pos: [B] int, the position each row writes. Returns (hidden [B, n],
        k_cache, v_cache)."""
        out, k_cache, v_cache = MultiHeadAttentionLayer.verify_chunk(
            params, conf, x[:, None], k_cache, v_cache, pos, tp)
        return out[:, 0], k_cache, v_cache

    @staticmethod
    def decode_step_paged(params, conf, x, k_pool, v_pool, pos, page_table,
                          tp=None):
        """`decode_step` against a shared physical page pool:
        `verify_chunk_paged` of one token."""
        out, k_pool, v_pool = MultiHeadAttentionLayer.verify_chunk_paged(
            params, conf, x[:, None], k_pool, v_pool, pos, page_table, tp)
        return out[:, 0], k_pool, v_pool

    @staticmethod
    def verify_chunk(params, conf, x, k_cache, v_cache, pos, tp=None):
        """K tokens a row at once against the KV cache (speculative
        verification; one token is `decode_step`).

        x: [B, K, n], the chunk's hidden rows; caches: [B, max_S, n]; pos:
        [B] int, the position of each row's first chunk token. Token i's
        K/V row is written at pos + i in place (indexing with device
        tensors, no host read), and token i attends to key positions
        <= pos + i (`_decode_attend`), the mask the i-th of K one-token
        steps would apply. The caller keeps pos + K <= max_S. Positions a
        caller rejects need no rollback: its next call writes them before
        it reads them. Returns (hidden [B, K, n], k_cache, v_cache)."""
        q, k, v = MultiHeadAttentionLayer._decode_qkv(params, conf, x)
        b, kk = x.shape[:2]
        rows = torch.arange(b, device=x.device)[:, None]
        idx = pos.long()[:, None] + torch.arange(kk, device=x.device)
        k_cache[rows, idx] = k.to(k_cache.dtype)
        v_cache[rows, idx] = v.to(v_cache.dtype)
        out = MultiHeadAttentionLayer._decode_attend(params, conf, x, q,
                                                     k_cache, v_cache, idx,
                                                     tp)
        return out, k_cache, v_cache

    @staticmethod
    def verify_chunk_paged(params, conf, x, k_pool, v_pool, pos, page_table,
                           tp=None):
        """`verify_chunk` against a shared physical page pool.

        x: [B, K, n]; pools: [n_pages, page_size, n]; pos: [B] int;
        page_table: [B, pages_per_slot] int of physical page ids. Token i's
        K/V row is written in place at (page_table[b, idx // ps], idx % ps)
        with idx = pos + i, and the row's pages are gathered back into one
        [B, pages_per_slot * ps, n] context for the dense chunk's own score
        code: where max_seq is a whole number of pages, the operands have
        the dense cache's shape and layout and the same products run, so
        paged tokens equal dense ones bit for bit. Table entries not
        allocated point at the host's scratch page 0, whose junk sits
        behind the additive mask (exp(-1e30 + .) is exactly 0.0). Every
        inactive row writes page 0 too, so that page can take duplicate
        indices in one write: which value lands there is unspecified, and
        nothing reads it unmasked."""
        q, k, v = MultiHeadAttentionLayer._decode_qkv(params, conf, x)
        b, kk = x.shape[:2]
        ps = k_pool.shape[1]
        rows = torch.arange(b, device=x.device)[:, None]
        idx = pos.long()[:, None] + torch.arange(kk, device=x.device)
        table = page_table.long()
        phys = table[rows, idx // ps]
        off = idx % ps
        k_pool[phys, off] = k.to(k_pool.dtype)
        v_pool[phys, off] = v.to(v_pool.dtype)
        ctx = table.shape[1] * ps
        k_ctx = k_pool[table].view(b, ctx, -1)
        v_ctx = v_pool[table].view(b, ctx, -1)
        out = MultiHeadAttentionLayer._decode_attend(params, conf, x, q,
                                                     k_ctx, v_ctx, idx, tp)
        return out, k_pool, v_pool

    @staticmethod
    def _attend(conf, q, k, v):
        """Impl dispatch: "flash" -> the flash kernel's wrapper, "blockwise",
        "full". On CUDA, "auto" resolves to "flash": the JAX package's
        crossover to dense attention (nn/layers/attention.py:86-116) is a
        TPU v5e measurement and is not carried over; an H100 crossover is
        open work (ROADMAP.md item 28). On the CPU, "auto" keeps the JAX
        rule: "blockwise" when a block size is set, else "full". The conf's
        block size does not reach the kernel, whose tiles are its own.

        Under autograd, "flash" takes the fused backward kernels when
        `conf.attention_fused_bwd` is set, else a blockwise recompute (JAX
        :117-125). `conf.attention_block_skip` changes no value in the JAX
        package (pallas_kernels.py:120-124), so the port's kernels skip
        fully-masked tiles whatever it says, and it is not passed on."""
        blk = conf.attention_block_size
        impl = conf.attention_impl
        if impl == "auto":
            if q.is_cuda:
                impl = "flash"
            else:
                impl = "blockwise" if blk else "full"
        if impl == "flash":
            return kernels.flash_attention(
                q, k, v, conf.causal, fused_bwd=conf.attention_fused_bwd)
        if impl == "blockwise":
            return blockwise_attention(q, k, v, block_size=blk or 512,
                                       causal=conf.causal)
        if impl == "full":
            return full_attention(q, k, v, causal=conf.causal)
        raise ValueError(f"unknown attention_impl {impl!r}")


class TransformerFFNLayer:
    """Pre-LN residual MLP, hidden width conf.ffn_hidden (default 4*n_in)."""

    @staticmethod
    def init(key, conf):
        n = conf.n_in
        k1, k2 = nd_random.split(key)
        if conf.n_out not in (0, n):
            raise ValueError(
                f"ffn is residual: n_out must equal n_in={n} (or 0), "
                f"got {conf.n_out}")
        hid = conf.ffn_hidden or 4 * n
        d, dev = param_dtype(conf), key.device
        return {
            "W1": init_weights(k1, (n, hid), conf.weight_init,
                               _sampler(conf), d),
            "b1": _vector(hid, 0.0, conf, dev),
            "W2": init_weights(k2, (hid, n), conf.weight_init,
                               _sampler(conf), d),
            "b2": _vector(n, 0.0, conf, dev),
            "ln_g": _vector(n, 1.0, conf, dev),
            "ln_b": _vector(n, 0.0, conf, dev),
        }

    @staticmethod
    def forward(params, conf, x, key=None, training=False, tp=None):
        """Under a model axis (`tp`) the params hold this rank's F/M hidden
        units: columns of W1 and b1, rows of W2, the partial down
        projection summed over the model group before `b2`."""
        xn = _layer_norm(x, params["ln_g"], params["ln_b"])
        if tp is not None:
            xn = tp.copy_to_model(xn)
        # jax.nn.gelu defaults to the tanh approximation
        hid = F.gelu(mixed_matmul(xn, params["W1"], conf) + params["b1"],
                     approximate="tanh")
        o = mixed_matmul(hid, params["W2"], conf)
        if tp is not None:
            o = tp.reduce_from_model(o)
        o = o + params["b2"]
        return x + _dropped(conf, o, key, training, tp)
