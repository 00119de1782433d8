"""Cache-aware autoregressive decoding over a stacked network.

Counterpart of `deeplearning4j_tpu/nn/decode.py` for the dense and the
paged KV cache. Generation splits into two programs instead of re-running the whole prefix
every token:

  prefill      the prompt once through the sequence forward (on CUDA the
               attention layers run the flash kernel), recording attention
               K/V rows into [B, max_S, n] caches and LSTM carries (h, c),
               and the next-token log-probs at each row's last real prompt
               position;
  decode_step  every row one token further against the recorded state:
               attention scores are [B, H, max_S] (one sequence-long axis,
               never [S, S]), and the LSTM steps its concat-form cell as
               `models/char_lstm.py`'s sampler does.

Both return `log(clip(probs, 1e-9, 1))`, the sampler's transform, so a
greedy cached decode reproduces the eager token trajectory in f32. The
captured programs (keys, static state, sampling) are in
`optimize/infer_cache.py`; this module is the layer math.

State: one dict per layer, in layer order, as a tuple:
  LSTM/GRAVES_LSTM  {"h": [B, H] f32, "c": [B, H] f32}
  ATTENTION         {"k": [B, max_S, n] compute dtype, "v": same}
  everything else   {}
Where the JAX package returns a new state, the port writes the attention
caches in place (the K/V rows a call computes) and returns new (h, c)
tensors; the infer cache copies those into the state it was given, so a
captured graph reads and writes one set of buffers and no step copies a
cache.

Paged state (`init_paged_state`): each ATTENTION layer's table becomes one
physical page pool {"k": [n_pages, page_size, n], "v": same} shared by the
rows, addressed through a per-call page table [B, pages_per_slot] of page
ids (`decode_step_paged`); memory scales with the pages in use. The host
(`serving/batcher.py`) keeps the free list and page 0 as a scratch page.

`decode_block` runs K decode steps in one program, sampling inside
(the infer cache's `decode_multi`): the JAX package's `lax.scan` is a
Python loop of K steps here, so one CUDA graph holds the whole block.

Under a model axis (`tp`, the serving `parallel/tensor.ServeParallel`)
each rank holds its H/M heads of every attention layer and its F/M hidden
units of every FFN: `init_state`/`init_paged_state` give it the heads' n/M
K/V columns, every function takes `tp` and hands it to those layers, and
the logits come out whole on every rank. The recurrent carries stay whole
on every rank (the JAX package's state spec splits them over the model
axis, a layout hint its programs gather back; ROADMAP.md queue C).

`verify_chunk` / `verify_chunk_paged` (speculative decoding) advance every
row K given tokens in one pass: the attention layers take the chunk at once
(`MultiHeadAttentionLayer.verify_chunk`), the LSTM layers unroll `step`
over it, and the logp of every chunk position comes back with each
recurrent layer's carries after every position, so that the caller can
roll them back to the accepted depth.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf import LayerType, MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import get_layer
from deeplearning4j_tpu_torch.nn.layers.base import compute_dtype
from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer

#: hidden layer types the decode path can step one token at a time
GENERATIVE_HIDDEN = (LayerType.LSTM, LayerType.GRAVES_LSTM,
                     LayerType.ATTENTION, LayerType.TRANSFORMER_FFN)

_RECURRENT = (LayerType.LSTM, LayerType.GRAVES_LSTM)

#: the token `decode_block` emits for the steps a row sat frozen (its `rem`
#: budget spent mid-block); never a valid token id
BLOCK_SENTINEL = -1


def check_generative(conf: MultiLayerConfiguration):
    """Raise ValueError unless `conf` is a decodable generative stack, and
    return its layer types: an optional leading EMBEDDING, then LSTM,
    GRAVES_LSTM, ATTENTION (causal only) or TRANSFORMER_FFN layers, then an
    OUTPUT layer; the only preprocessor allowed is the trailing rnn_to_ff
    (which the per-token decode skips: its rows are already [B, n])."""
    n = conf.n_layers
    if n < 2:
        raise ValueError("generation needs at least one hidden layer "
                         "and an OUTPUT layer")
    types = [LayerType(str(conf.conf(i).layer_type)) for i in range(n)]
    if types[-1] != LayerType.OUTPUT:
        raise ValueError(f"last layer must be OUTPUT, got {types[-1]}")
    start = 1 if types[0] == LayerType.EMBEDDING else 0
    for i, t in enumerate(types[start:-1], start):
        if t not in GENERATIVE_HIDDEN:
            raise ValueError(
                f"layer {i} ({t}) has no single-token decode path; "
                f"generative stacks may use "
                f"{[str(x) for x in GENERATIVE_HIDDEN]}")
        if t == LayerType.ATTENTION and not conf.conf(i).causal:
            raise ValueError(
                f"layer {i}: only causal attention can decode "
                f"autoregressively")
    for idx, name in conf.input_preprocessors:
        if not (idx == n - 1 and name == "rnn_to_ff"):
            raise ValueError(
                f"preprocessor {name!r} at layer {idx} is incompatible "
                f"with token decoding (only the trailing rnn_to_ff is)")
    return types


def positional_bound(conf: MultiLayerConfiguration) -> int:
    """The sequence-length ceiling of a learned positional table, or 0 when
    the stack has none (one-hot and recurrent stacks decode unbounded).
    Admission (`serving/batcher.py`) enforces it on the host."""
    types = check_generative(conf)
    if types[0] == LayerType.EMBEDDING:
        return int(conf.conf(0).max_seq_len or 0)
    return 0


def _kv_width(c, tp) -> int:
    """An attention layer's K/V columns on this rank: n, or n/M under a
    model axis of M."""
    return c.n_in // (1 if tp is None else tp.size)


def init_state(conf: MultiLayerConfiguration, batch: int, max_seq: int,
               device=None, tp=None):
    """A fresh (zero) decode state for `batch` rows and a `max_seq`-token
    table, on `device` (under `tp`, this rank's K/V columns)."""
    types = check_generative(conf)
    if types[0] == LayerType.EMBEDDING:
        table = conf.conf(0).max_seq_len
        if table and max_seq > table:
            raise ValueError(
                f"max_seq={max_seq} exceeds the learned positional table "
                f"(max_seq_len={table})")
    state = []
    # made outside any inference_mode, so that the programs may write them
    # in place whatever mode they run in
    with torch.inference_mode(False):
        for i, t in enumerate(types):
            c = conf.conf(i)
            if t in _RECURRENT:
                # f32, like the eager sampler's zero carries
                state.append({name: torch.zeros((batch, c.n_out),
                                                device=device)
                              for name in ("h", "c")})
            elif t == LayerType.ATTENTION:
                state.append({name: torch.zeros(
                    (batch, max_seq, _kv_width(c, tp)),
                    dtype=compute_dtype(c), device=device)
                    for name in ("k", "v")})
            else:
                state.append({})
    return tuple(state)


def init_paged_state(conf: MultiLayerConfiguration, batch: int,
                     n_pages: int, page_size: int, device=None, tp=None):
    """A fresh (zero) paged decode state: recurrent carries stay [batch, H]
    a row, each ATTENTION layer's K/V become one shared physical pool
    [n_pages, page_size, n] (n/M under `tp`) that the per-call page table
    addresses."""
    types = check_generative(conf)
    state = []
    with torch.inference_mode(False):
        for i, t in enumerate(types):
            c = conf.conf(i)
            if t in _RECURRENT:
                state.append({name: torch.zeros((batch, c.n_out),
                                                device=device)
                              for name in ("h", "c")})
            elif t == LayerType.ATTENTION:
                state.append({name: torch.zeros(
                    (n_pages, page_size, _kv_width(c, tp)),
                    dtype=compute_dtype(c), device=device)
                    for name in ("k", "v")})
            else:
                state.append({})
    return tuple(state)


def one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows of `ids` ([...] -> [..., n]); ids outside [0, n)
    give a zero row, as `jax.nn.one_hot` does. A comparison, so it reads
    nothing back to the host (`F.one_hot` checks the range on the host)."""
    return (ids.long()[..., None]
            == torch.arange(n, device=ids.device)).to(torch.float32)


def token_embed(conf: MultiLayerConfiguration, params, tok, pos):
    """One token id a row: an EMBEDDING stack gathers W[tok] (+ P[pos] row
    by row where it has a positional table; not `EmbeddingLayer.forward`,
    whose P[:s] would read a [B] id vector as one sequence); a one-hot stack
    builds the f32 rows the eager sampler feeds."""
    c0 = conf.conf(0)
    if LayerType(str(c0.layer_type)) == LayerType.EMBEDDING:
        e = params[0]["W"][tok.long()]
        if "P" in params[0]:
            e = e + params[0]["P"][pos.long()]
        return e
    return one_hot(tok, c0.n_in)


def _log_probs(conf, params, n_hidden: int, x):
    """log(clip(probs, 1e-9, 1)) of the next token. The head (softmax and
    log) runs in float32 whatever the pre-activation's dtype: a serve
    policy's bfloat16 logits would otherwise tie at bfloat16's resolution,
    where the JAX package's XLA program keeps float32 (float32 programs
    are unchanged)."""
    c = conf.conf(n_hidden)
    z = OutputLayer.preout(params[n_hidden], c, x)
    probs = OutputLayer.head(c, z.float())
    return torch.log(torch.clamp(probs, 1e-9, 1.0))


def _step(conf, params, state, tok, pos, page_table, tp=None):
    types = check_generative(conf)
    x = token_embed(conf, params, tok, pos)
    new_state = []
    for i, t in enumerate(types[:-1]):
        c = conf.conf(i)
        impl = get_layer(c.layer_type)
        if t in _RECURRENT:
            h, cc = impl.step(params[i], c, x, state[i]["h"], state[i]["c"])
            new_state.append({"h": h, "c": cc})
            x = h
        elif t == LayerType.ATTENTION:
            if page_table is None:
                x, kc, vc = impl.decode_step(params[i], c, x, state[i]["k"],
                                             state[i]["v"], pos, tp)
            else:
                x, kc, vc = impl.decode_step_paged(
                    params[i], c, x, state[i]["k"], state[i]["v"], pos,
                    page_table, tp)
            new_state.append({"k": kc, "v": vc})
        elif t == LayerType.TRANSFORMER_FFN:
            x = impl.forward(params[i], c, x, tp=tp)
            new_state.append({})
        else:  # EMBEDDING: token_embed consumed it
            new_state.append({})
    new_state.append({})
    return _log_probs(conf, params, len(types) - 1, x), tuple(new_state)


def decode_step(conf: MultiLayerConfiguration, params, state, tok, pos,
                tp=None):
    """Every row one token further: tok [B] int (the row's current token),
    pos [B] int (the position that token takes). Returns (logp [B, vocab],
    log(clip(probs)) of the NEXT token, and the state tuple: the attention
    caches written in place at `pos`, new (h, c) tensors)."""
    return _step(conf, params, state, tok, pos, None, tp)


def decode_step_paged(conf: MultiLayerConfiguration, params, state, tok,
                      pos, page_table, tp=None):
    """`decode_step` over a paged state: page_table [B, pages_per_slot] int
    routes each row's cache reads and writes through the shared pool
    (`MultiHeadAttentionLayer.decode_step_paged`)."""
    return _step(conf, params, state, tok, pos, page_table, tp)


def decode_block(conf: MultiLayerConfiguration, params, state, tok, pos,
                 keys, temps, rem, k: int, sample, page_table=None,
                 tp=None):
    """Every row up to `k` tokens further in one program: `k` unrolled
    `decode_step`s (`decode_step_paged` with a `page_table`), each followed
    by `sample(logp, keys, temps) -> (tok, keys)`. The tokens are those of
    `k` one-step calls, for any `k`.

    rem [B] int is each row's remaining budget. A row whose budget reaches
    0 mid-block freezes: its tok, pos and key stop, its recurrent carries
    stop (`torch.where` over [B]-shaped rows, no select over a cache), and
    its outputs become `BLOCK_SENTINEL`. Its K/V rows need no mask: with
    tok, pos and carries frozen, each further step writes the same cell
    with the same values (the same inputs through the same kernels), the
    values the row's next real step would write; a released paged row's
    table points every write at the scratch page. The sampler runs over
    every row each step, but a frozen row's advanced key is dropped, so a
    key splits once a token emitted, as in one-step decoding.

    Returns (toks [k, B] int32, the last token of each row [B], keys
    [B, 2], state): attention caches written in place, new (h, c)."""
    types = check_generative(conf)
    outs = []
    for _ in range(int(k)):
        active = rem > 0
        logp, new = _step(conf, params, state, tok, pos, page_table, tp)
        tok2, keys2 = sample(logp, keys, temps)
        frozen = []
        for i, t in enumerate(types):
            if t in _RECURRENT:
                frozen.append({name: torch.where(active[:, None],
                                                 new[i][name],
                                                 state[i][name])
                               for name in ("h", "c")})
            else:
                frozen.append(new[i])
        state = tuple(frozen)
        outs.append(tok2.masked_fill(~active, BLOCK_SENTINEL))
        tok = torch.where(active, tok2, tok)
        keys = torch.where(active[:, None], keys2, keys)
        pos = torch.where(active, pos + 1, pos)
        rem = torch.where(active, rem - 1, rem)
    return torch.stack(outs), tok, keys, state


def _verify_chunk_impl(conf, params, state, toks, pos, page_table, tp=None):
    """The body of `verify_chunk` and `verify_chunk_paged`."""
    types = check_generative(conf)
    b, kk = toks.shape
    idx = pos.long()[:, None] + torch.arange(kk, device=toks.device)
    x = token_embed(conf, params, toks, idx)  # [B, K, n]
    new_state, carries = [], []
    for i, t in enumerate(types[:-1]):
        c = conf.conf(i)
        impl = get_layer(c.layer_type)
        if t in _RECURRENT:
            h, cc = state[i]["h"], state[i]["c"]
            hs, cs = [], []
            for j in range(kk):  # K is small and static: unrolled
                h, cc = impl.step(params[i], c, x[:, j], h, cc)
                hs.append(h)
                cs.append(cc)
            new_state.append({"h": h, "c": cc})
            carries.append({"h": torch.stack(hs, dim=1),
                            "c": torch.stack(cs, dim=1)})
            x = carries[-1]["h"]
        elif t == LayerType.ATTENTION:
            if page_table is None:
                x, kc, vc = impl.verify_chunk(params[i], c, x, state[i]["k"],
                                              state[i]["v"], pos, tp)
            else:
                x, kc, vc = impl.verify_chunk_paged(
                    params[i], c, x, state[i]["k"], state[i]["v"], pos,
                    page_table, tp)
            new_state.append({"k": kc, "v": vc})
            carries.append({})
        elif t == LayerType.TRANSFORMER_FFN:
            x = impl.forward(params[i], c, x, tp=tp)
            new_state.append({})
            carries.append({})
        else:  # EMBEDDING: token_embed consumed it
            new_state.append({})
            carries.append({})
    logp = _log_probs(conf, params, len(types) - 1, x.reshape(b * kk, -1))
    new_state.append({})
    carries.append({})
    return logp.reshape(b, kk, -1), tuple(new_state), tuple(carries)


def verify_chunk(conf: MultiLayerConfiguration, params, state, toks, pos,
                 tp=None):
    """Speculative verification: every row K tokens further in one pass.
    toks [B, K] int (column 0 the row's current token, the rest a draft's
    continuation), pos [B] int the position of column 0 (pos + K <= the
    table's length). Returns (logp [B, K, vocab]: logp[:, i] is what
    `decode_step` returns on the i-th of K one-token calls, the state:
    attention caches written in place, the recurrent layers' (h, c) after
    all K tokens, and carries: for each recurrent layer {"h", "c"} as
    [B, K, hidden] stacks of its carries after each token, {} for every
    other layer). A caller that accepts e < K tokens rolls a recurrent
    layer back to index e - 1 of its stacks; attention needs no rollback,
    since the rejected positions are written again before they are read."""
    return _verify_chunk_impl(conf, params, state, toks, pos, None, tp)


def verify_chunk_paged(conf: MultiLayerConfiguration, params, state, toks,
                       pos, page_table, tp=None):
    """`verify_chunk` over a paged state (page_table [B, pages_per_slot],
    `MultiHeadAttentionLayer.verify_chunk_paged`)."""
    return _verify_chunk_impl(conf, params, state, toks, pos, page_table, tp)


def prefill(conf: MultiLayerConfiguration, params, state, prompt, length,
            tp=None):
    """Fill the decode state from a prompt bucket: prompt [B, T] int
    (zero-padded past each row's `length`), length [B] int >= 1. Returns
    (logp [B, vocab] at each row's last real prompt position, what the
    first generated token is drawn from, and the state: attention caches
    written in place over [0, T), new (h, c) tensors).

    Padding is inert: LSTM carries freeze at t >= length, the causal mask
    hides later positions from every real one, and `decode_step` writes
    position `pos` before it attends to it."""
    types = check_generative(conf)
    c0 = conf.conf(0)
    if types[0] == LayerType.EMBEDDING:
        x = get_layer(c0.layer_type).forward(params[0], c0, prompt)
    else:
        x = one_hot(prompt, c0.n_in)
    new_state = []
    for i, t in enumerate(types[:-1]):
        c = conf.conf(i)
        impl = get_layer(c.layer_type)
        if t in _RECURRENT:
            x, h, cc = impl.prefill(params[i], c, x, state[i]["h"],
                                    state[i]["c"], length)
            new_state.append({"h": h, "c": cc})
        elif t == LayerType.ATTENTION:
            x, kc, vc = impl.prefill(params[i], c, x, state[i]["k"],
                                     state[i]["v"], tp)
            new_state.append({"k": kc, "v": vc})
        elif t == LayerType.TRANSFORMER_FFN:
            x = impl.forward(params[i], c, x, tp=tp)
            new_state.append({})
        else:  # EMBEDDING
            new_state.append({})
    rows = torch.arange(prompt.shape[0], device=x.device)
    last = x[rows, length.long() - 1]
    new_state.append({})
    return _log_probs(conf, params, len(types) - 1, last), tuple(new_state)
