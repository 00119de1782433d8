"""Captured inference: one CUDA graph per (entry point, conf, bucket).

Counterpart of `deeplearning4j_tpu/optimize/infer_cache.py` for its
single-device f32 entry points `output`, `feed_forward`, `loss`, `decode`
and `prefill`, over
the `CompiledProgramCache` machinery of `optimize/step_cache.py`:

  key schema    (entry point, conf fingerprint, arg shapes/dtypes,
                "single"). `attention_fused_bwd` changes only the backward,
                so it is normalised out of the fingerprint, as in the JAX
                package: flipping it for training re-keys no serving
                program.
  bucketing     a ragged batch pads with zero rows up to the smallest known
                row bucket; `output` and `feed_forward` slice the pad rows
                back off (`truncate_rows`), and `loss` weighs them 0 in a
                weighted mean.
  outputs       a replay overwrites the graph's static outputs, so the
                entry points return copies, made under the pool's lock.
  params        read by address, as the train step writes them, so
                training between two calls is seen by the second.

Generation (the JAX package's `init_decode_state`, `decode`, `prefill`,
`init_paged_decode_state`, `decode_paged`, `decode_multi`,
`decode_multi_paged`, `prefill_logp`, `verify` and `verify_paged`):

  key schema    (entry point, conf fingerprint, arg signature with the
                state's leaves, "single"), the JAX package's.
  state         a graph reads and writes the decode state by address, as
                the train step does its params: the state is the graph's
                static buffers, and a call writes it in place (the new K/V
                rows at their positions, the new LSTM carries copied over
                the old). No step copies a KV cache in or out. A call with
                a state at other addresses captures anew, so the batcher
                and `warmup_generate` share the cache's own states
                (`decode_state`, one per role).
  sampling      inside the program (`nd/random.sample_tokens`): JAX's
                threefry keys bit for bit, one split a row a call.
  capture       the warm-up call before a capture writes the same K/V rows
                the replay writes and leaves the carries alone (the carries
                are written by the program's `write`, which only the
                capture records), so capturing mid-stream changes nothing.
  blocks        `decode_multi[k]` is K steps in one graph; its outputs are
                device copies made under the pool's lock, so a caller may
                feed one block's tokens and keys to the next dispatch
                without reading them back (the batcher's pipelined loop).
                Ids given as CUDA tensors are not checked on the host:
                they are a program's own samples, and a check would read
                them back.
  paged         the page pool is a state of its own role, keyed by its
                (n_pages, page_size); the page table is a static input.
  verify        speculative decoding's K-token step: one graph
                chain-samples K tokens with each row's key stream (the
                splits K one-step calls would make) and rolls the recurrent
                carries back to the accepted depth in the program
                (`_accepted_len`, `_rollback_carries`).

The mesh and plan entry points come with tensor parallelism (ROADMAP.md
queue A item 10b) and the precision policies with serving-side optimisation (item
11).
"""

from __future__ import annotations

from typing import Callable, Dict, Set, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nd.platform import resolve_device
from deeplearning4j_tpu_torch.optimize.step_cache import (CompiledProgramCache,
                                                          arg_signature,
                                                          check_input)
from deeplearning4j_tpu_torch.optimize.tree import tree_leaves


def pad_rows(x: torch.Tensor, bucket: int) -> torch.Tensor:
    """Zero-pad `x` with rows up to `bucket` (feature rows = axis 0)."""
    pad = bucket - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x


def truncate_rows(arr: torch.Tensor, bucket: int, n: int) -> torch.Tensor:
    """A program output cut back to the `n` real input rows. Activations may
    carry `bucket` rows or a whole multiple of it (B*T rows where an
    `rnn_to_ff` preprocessor flattened time into the batch); pad rows take
    the trailing block either way. An output whose leading dim is not tied
    to the batch passes through."""
    if arr.dim() and arr.shape[0] and arr.shape[0] % bucket == 0:
        return arr[: n * (arr.shape[0] // bucket)]
    return arr


class InferCache(CompiledProgramCache):
    """Keyed captured programs for the inference entry points."""

    kind = "infer-cache"

    #: key element of programs made without a mesh (the JAX package's tag)
    SINGLE = "single"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # (fingerprint, batch, max_seq, device, role, pages) -> the decode
        # state the graphs of that role are captured on (`decode_state`)
        self._decode_states: Dict[Tuple, tuple] = {}
        self._claimed: Set[int] = set()

    def _keyed_conf(self, conf):
        if any(c.attention_fused_bwd for c in conf.confs):
            return conf.replace(confs=tuple(
                c.replace(attention_fused_bwd=False) for c in conf.confs))
        return conf

    def output(self, conf, params, x, compile_only: bool = False):
        """`network_output` through the cache: the output activations of the
        `x.shape[0]` real rows (a copy). `compile_only` (warm-up) registers
        the bucket and captures the program without running it."""
        check_input(conf, x)
        n = int(x.shape[0])
        bucket = self.bucket_rows(n)
        xp = pad_rows(x, bucket)
        key = ("output", self._fingerprint(conf), arg_signature(xp),
               self.SINGLE)
        return self._run(key, lambda: _output_program(conf), params, (xp,),
                         read=lambda out: truncate_rows(out, bucket,
                                                        n).clone(),
                         compile_only=compile_only)

    def feed_forward(self, conf, params, x, compile_only: bool = False):
        """`feed_forward` through the cache: the per-layer activations, each
        cut back to the real rows (copies)."""
        check_input(conf, x)
        n = int(x.shape[0])
        bucket = self.bucket_rows(n)
        xp = pad_rows(x, bucket)
        key = ("feed_forward", self._fingerprint(conf), arg_signature(xp),
               self.SINGLE)
        return self._run(key, lambda: _feed_forward_program(conf), params,
                         (xp,),
                         read=lambda acts: [truncate_rows(a, bucket,
                                                          n).clone()
                                            for a in acts],
                         compile_only=compile_only)

    def programs_summary(self):
        """Resident programs as (entry, bucket, sharding, policy) rows, the
        JAX package's `/v1/stats` `programs` block: bucket is the leading
        dim of the first argument (rows, or a decode table's slots)."""
        with self._lock:
            keys = list(self._programs)
        rows = [{"entry": k[0],
                 "bucket": int(k[2][0][0][0]) if k[2] and k[2][0] else 0,
                 "sharding": k[3], "policy": "f32"} for k in keys]
        return sorted(rows, key=lambda r: (r["entry"], r["bucket"]))

    # -- generation -----------------------------------------------------------
    def init_decode_state(self, conf, batch: int, max_seq: int,
                          device=None):
        """A fresh zero decode state (`nn/decode.init_state`) on `device`
        (None: CUDA)."""
        from deeplearning4j_tpu_torch.nn import decode as decode_mod

        return decode_mod.init_state(conf, batch, max_seq,
                                     device=resolve_device(device))

    def init_paged_decode_state(self, conf, batch: int, n_pages: int,
                                page_size: int, device=None):
        """A fresh zero paged decode state (`nn/decode.init_paged_state`):
        a pool of `n_pages` physical pages of `page_size` tokens."""
        from deeplearning4j_tpu_torch.nn import decode as decode_mod

        return decode_mod.init_paged_state(conf, batch, n_pages, page_size,
                                           device=resolve_device(device))

    def decode_state(self, conf, batch: int, max_seq: int, device=None,
                     role: str = "table", pages=None):
        """The cache's own decode state for `role` (the batcher's "table",
        its paged "pool" and its B = 1 admission "row"; `warmup_generate`
        captures on the same ones), made on first use and kept: the graphs
        read it by address, so the programs warmed on it replay for its
        later users. `pages` = (n_pages, page_size) makes a paged state,
        and is part of the key. Its content is what the last call left;
        `reset_state` zeroes it."""
        dev = resolve_device(device)
        key = (self._fingerprint(conf), int(batch), int(max_seq), str(dev),
               role, None if pages is None else tuple(int(p) for p in pages))
        with self._lock:
            state = self._decode_states.get(key)
            if state is None:
                state = self._fresh_state(conf, batch, max_seq, dev, pages)
                self._decode_states[key] = state
            return state

    def _fresh_state(self, conf, batch, max_seq, device, pages):
        if pages is None:
            return self.init_decode_state(conf, batch, max_seq, device)
        return self.init_paged_decode_state(conf, batch, *pages, device)

    def claim_decode_state(self, conf, batch: int, max_seq: int,
                           device=None, role: str = "table", pages=None):
        """`decode_state` for a user that writes it for a while (a running
        batcher): while one holds it, another claimant gets a private fresh
        state, so that two batchers on one network never write each
        other's rows. Their calls share the key's one graph, which is
        captured anew whenever the state changes: right, but slow while
        both decode. `release_state` gives it back."""
        state = self.decode_state(conf, batch, max_seq, device, role, pages)
        with self._lock:
            if id(state) not in self._claimed:
                self._claimed.add(id(state))
                return state
        return self._fresh_state(conf, batch, max_seq, device, pages)

    def release_state(self, state) -> None:
        with self._lock:
            self._claimed.discard(id(state))

    @staticmethod
    def reset_state(state) -> None:
        """Zero every tensor of a decode state in place."""
        with torch.no_grad():
            for t in tree_leaves(state):
                t.zero_()

    def _decode_inputs(self, conf, params, state, tok, *rest):
        """The call's tensors on the program's device: `tok` (or the prompt)
        as int32, then each of `rest`, an (array, dtype) pair; keys given as
        uint32 arrays become int64 holding uint32. Token ids of an embedding
        stack that come from the host are checked there first (a captured
        program cannot); ids in a CUDA tensor are a program's own samples,
        in range by construction, and checking them would read them back.
        Host arrays go to the card from pinned memory without blocking, so
        that a call does not wait for the previous replay to end before it
        is queued; `pin_memory` copies them first, so the caller may rewrite
        its arrays as soon as the call returns."""
        leaves = tree_leaves(state) or tree_leaves(params)
        dev = leaves[0].device
        if not (isinstance(tok, torch.Tensor) and tok.is_cuda):
            check_input(conf, tok if isinstance(tok, torch.Tensor)
                        else torch.as_tensor(np.asarray(tok)))

        def put(t):
            if dev.type == "cuda" and not t.is_cuda:
                return t.pin_memory().to(dev, non_blocking=True)
            return t.to(dev)

        out = [put(torch.as_tensor(np.asarray(tok) if not isinstance(
            tok, torch.Tensor) else tok).to(torch.int32))]
        for a, dtype in rest:
            if isinstance(a, np.ndarray) and a.dtype == np.uint32:
                a = nd_random.key_array(a)
            out.append(put(torch.as_tensor(a)).to(dtype))
        return tuple(out)

    def _generation(self, entry, build, conf, params, state, read,
                    compile_only, tok, *rest):
        """One generation program's call: its inputs on the device
        (`_decode_inputs`), its key (entry, conf fingerprint, the signature
        of the inputs and the state's leaves, "single"), and `_run` with the
        new carries written into `state`. Returns `read` of the outputs, or
        None with `compile_only`."""
        args = self._decode_inputs(conf, params, state, tok, *rest)
        key = (entry, self._fingerprint(conf),
               arg_signature(*args, *tree_leaves(state)), self.SINGLE)
        return self._run(key, build, (params, state), args, read=read,
                         write=_write_carries, compile_only=compile_only)

    def decode(self, conf, params, state, tok, pos, keys, temps,
               compile_only: bool = False):
        """One KV-cache decode step over the whole slot table: tok, pos [B]
        int, keys [B, 2] (uint32 values), temps [B] float32 (rows at <= 0
        decode greedily). Returns (next_tok [B] int32, advanced keys [B, 2]
        int64, state), the state written in place. On CUDA the replay of one
        captured graph per key; on the CPU the program, eagerly."""
        out = self._generation(
            "decode", lambda: _decode_program(conf), conf, params, state,
            _read_tokens, compile_only, tok, (pos, torch.int32),
            (keys, torch.int64), (temps, torch.float32))
        return None if compile_only else (*out, state)

    def prefill(self, conf, params, state, prompt, length, keys, temps,
                compile_only: bool = False):
        """The prompt prefill: prompt [B, T_bucket] int (zero-padded),
        length [B] int. Fills the state in place and draws each row's first
        generated token. Returns (tok [B] int32, keys [B, 2], state). One
        program per (conf, rows, prompt bucket, max_seq): the state's leaves
        are in the key."""
        out = self._generation(
            "prefill", lambda: _prefill_program(conf), conf, params, state,
            _read_tokens, compile_only, prompt, (length, torch.int32),
            (keys, torch.int64), (temps, torch.float32))
        return None if compile_only else (*out, state)

    def decode_paged(self, conf, params, state, tok, pos, keys, temps,
                     page_table, compile_only: bool = False):
        """`decode` over a paged state: page_table [B, pages_per_slot] int
        routes each row through the shared pool ("decode-paged")."""
        out = self._generation(
            "decode-paged", lambda: _decode_program(conf, paged=True), conf,
            params, state, _read_tokens, compile_only, tok,
            (pos, torch.int32), (keys, torch.int64), (temps, torch.float32),
            (page_table, torch.int32))
        return None if compile_only else (*out, state)

    def decode_multi(self, conf, params, state, tok, pos, keys, temps, rem,
                     k: int, compile_only: bool = False):
        """K decode steps in one program (`nn/decode.decode_block`), the
        tokens of K one-step calls: rem [B] int is each row's remaining
        budget; a row that spends it mid-block freezes and emits
        `BLOCK_SENTINEL`. Returns (toks [k, B] int32, the last token of each
        row [B], keys [B, 2], state), the three tensors device copies. K is
        in the entry name ("decode-multi[k]"), as in the JAX package."""
        out = self._generation(
            "decode-multi[%d]" % int(k),
            lambda: _decode_block_program(conf, int(k), False), conf, params,
            state, _read_block, compile_only, tok, (pos, torch.int32),
            (keys, torch.int64), (temps, torch.float32), (rem, torch.int32))
        return None if compile_only else (*out, state)

    def decode_multi_paged(self, conf, params, state, tok, pos, keys, temps,
                           rem, page_table, k: int,
                           compile_only: bool = False):
        """`decode_multi` over a paged state ("decode-multi-paged[k]"): the
        page table rides the whole block, so the caller allocates the pages
        of all `k` positions first."""
        out = self._generation(
            "decode-multi-paged[%d]" % int(k),
            lambda: _decode_block_program(conf, int(k), True), conf, params,
            state, _read_block, compile_only, tok, (pos, torch.int32),
            (keys, torch.int64), (temps, torch.float32), (rem, torch.int32),
            (page_table, torch.int32))
        return None if compile_only else (*out, state)

    def prefill_logp(self, conf, params, state, prompt, length,
                     compile_only: bool = False):
        """The prefill of the prefix cache: fills the state like `prefill`
        but returns (logp [B, vocab] float32, state) without sampling
        ("prefill-logp"); the batcher keeps the pair by prompt digest and
        samples each stream's first token on the host with its own key."""
        logp = self._generation(
            "prefill-logp", lambda: _prefill_logp_program(conf), conf, params,
            state, lambda out: out[0].clone(), compile_only, prompt,
            (length, torch.int32))
        return None if compile_only else (logp, state)

    def verify(self, conf, params, state, toks, pos, keys, temps,
               compile_only: bool = False):
        """Speculative verification over the whole slot table: toks [B, K]
        int (column 0 each row's current token, columns 1..K-1 a draft's
        proposals), pos [B] int the position of column 0, keys [B, 2],
        temps [B]. One program advances every row K positions
        (`nn/decode.verify_chunk`), chain-samples K tokens with the row's
        key stream, the splits K one-step `decode` calls would make
        (`_sample_chain`), and rolls each recurrent layer's carries back to
        the row's accepted depth: 1 + the leading proposals equal to the
        samples before them (`_accepted_len`). Returns (sampled [B, K]
        int32, keys_after [B, K, 2]: the keys after accepting 1..K tokens,
        state), the state written in place; the first two are device
        copies, and a CUDA `toks` (a draft's own proposals) is not checked
        on the host."""
        out = self._generation(
            "verify", lambda: _verify_program(conf, False), conf, params,
            state, _read_tokens, compile_only, toks, (pos, torch.int32),
            (keys, torch.int64), (temps, torch.float32))
        return None if compile_only else (*out, state)

    def verify_paged(self, conf, params, state, toks, pos, keys, temps,
                     page_table, compile_only: bool = False):
        """`verify` over a paged state ("verify-paged"): the caller has
        allocated the pages of all K positions."""
        out = self._generation(
            "verify-paged", lambda: _verify_program(conf, True), conf, params,
            state, _read_tokens, compile_only, toks, (pos, torch.int32),
            (keys, torch.int64), (temps, torch.float32),
            (page_table, torch.int32))
        return None if compile_only else (*out, state)

    def loss(self, conf, params, x, y, compile_only: bool = False):
        """`network_loss(training=False)` through the cache: the row-weighted
        mean loss over the real rows plus regularization, a 0-d float32
        tensor. Pad rows carry weight 0."""
        check_input(conf, x)
        n = int(x.shape[0])
        bucket = self.bucket_rows(n)
        xp, yp, w = self.pad_batch(x, y, bucket)
        key = ("loss", self._fingerprint(conf), arg_signature(xp, yp, w),
               self.SINGLE)
        return self._run(key, lambda: _loss_program(conf), params,
                         (xp, yp, w), read=lambda s: s.clone(),
                         compile_only=compile_only)


def _output_program(conf) -> Callable:
    # local import: nn.multilayer imports this module at top level
    from deeplearning4j_tpu_torch.nn.multilayer import network_output

    def program(params, x):
        with torch.inference_mode():
            return network_output(conf, params, x)

    return program


def _feed_forward_program(conf) -> Callable:
    from deeplearning4j_tpu_torch.nn.multilayer import feed_forward

    def program(params, x):
        with torch.inference_mode():
            return feed_forward(conf, params, x)

    return program


def _loss_program(conf) -> Callable:
    from deeplearning4j_tpu_torch.nn.multilayer import (network_regularization,
                                                        network_rowwise_loss)

    def program(params, x, y, w):
        with torch.inference_mode():
            rows = network_rowwise_loss(conf, params, x, y, training=False)
            return (torch.dot(rows, w) / torch.clamp(w.sum(), min=1.0)
                    + network_regularization(conf, params))

    return program


def _read_tokens(out):
    """Copies of a generation program's (tok, keys), made under the pool's
    lock: the next replay overwrites them."""
    return out[0].clone(), out[1].clone()


def _read_block(out):
    """Copies of a block program's (toks, tok, keys), made under the pool's
    lock."""
    return tuple(t.clone() for t in out)


def _write_carries(ps, out):
    """After a generation program: copy its new LSTM carries (its last
    output) into the state it was given (the attention caches were written
    in place), and hand on the other outputs."""
    state = ps[1]
    *rest, new = out
    with torch.no_grad():
        for layer, new_layer in zip(state, new):
            for name, t in new_layer.items():
                if t is not layer[name]:
                    layer[name].copy_(t)
    return tuple(rest)


def _decode_program(conf, paged: bool = False) -> Callable:
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    def program(ps, tok, pos, keys, temps, *page_table):
        params, state = ps
        with torch.inference_mode():
            if paged:
                logp, new = decode_mod.decode_step_paged(
                    conf, params, state, tok, pos, *page_table)
            else:
                logp, new = decode_mod.decode_step(conf, params, state, tok,
                                                   pos)
            tok2, keys2 = nd_random.sample_tokens(logp.float(), keys, temps)
        return tok2, keys2, new

    return program


def _sample_f32(logp, keys, temps):
    return nd_random.sample_tokens(logp.float(), keys, temps)


def _decode_block_program(conf, k: int, paged: bool) -> Callable:
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    def program(ps, tok, pos, keys, temps, rem, *page_table):
        params, state = ps
        with torch.inference_mode():
            return decode_mod.decode_block(
                conf, params, state, tok, pos, keys, temps, rem, k,
                _sample_f32, page_table=page_table[0] if paged else None)

    return program


def _sample_chain(logp, keys, temps):
    """One token a chunk position: position i draws from logp[:, i] with
    the keys position i - 1 left, the splits K one-step samplers make.
    Returns (toks [B, K] int32, keys_after [B, K, 2])."""
    toks, keys_after = [], []
    for i in range(logp.shape[1]):
        t, keys = nd_random.sample_tokens(logp[:, i], keys, temps)
        toks.append(t)
        keys_after.append(keys)
    return torch.stack(toks, dim=1), torch.stack(keys_after, dim=1)


def _accepted_len(toks, sampled):
    """Each row's accepted depth, in the program: e = 1 + the number of
    leading proposals toks[:, 1:] equal to the samples sampled[:, :-1]
    before them. Integer comparisons, so it equals the host's count on the
    read-back arrays."""
    b, kk = toks.shape
    if kk == 1:
        return torch.ones((b,), dtype=torch.int64, device=toks.device)
    agree = (toks[:, 1:].long() == sampled[:, :-1].long()).long()
    return 1 + torch.cumprod(agree, dim=1).sum(dim=1)


def _rollback_carries(state, carries, e):
    """`state` with each recurrent layer's (h, c) replaced by its carries
    after the e-th chunk token (index e - 1 of the [B, K, hidden] stacks):
    a carry advanced past the accepted tokens would condition every later
    token on rejected ones. Attention layers keep theirs."""
    rows = torch.arange(e.shape[0], device=e.device)
    return tuple({k: v[rows, e - 1] for k, v in car.items()} if car else lay
                 for lay, car in zip(state, carries))


def _verify_program(conf, paged: bool) -> Callable:
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    def program(ps, toks, pos, keys, temps, *page_table):
        params, state = ps
        with torch.inference_mode():
            if paged:
                logp, new, carries = decode_mod.verify_chunk_paged(
                    conf, params, state, toks, pos, *page_table)
            else:
                logp, new, carries = decode_mod.verify_chunk(
                    conf, params, state, toks, pos)
            sampled, keys_after = _sample_chain(logp.float(), keys, temps)
            new = _rollback_carries(new, carries,
                                    _accepted_len(toks, sampled))
        return sampled, keys_after, new

    return program


def _prefill_logp_program(conf) -> Callable:
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    def program(ps, prompt, length):
        params, state = ps
        with torch.inference_mode():
            logp, new = decode_mod.prefill(conf, params, state, prompt,
                                           length)
        return logp.float(), new

    return program


def _prefill_program(conf) -> Callable:
    from deeplearning4j_tpu_torch.nn import decode as decode_mod

    def program(ps, prompt, length, keys, temps):
        params, state = ps
        with torch.inference_mode():
            logp, new = decode_mod.prefill(conf, params, state, prompt,
                                           length)
            tok0, keys2 = nd_random.sample_tokens(logp.float(), keys, temps)
        return tok0, keys2, new

    return program
