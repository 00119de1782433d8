"""Char-LSTM language model: training, sampling, generation, beam search.

Counterpart of `deeplearning4j_tpu/models/char_lstm.py`. Training is the
`zoo.char_lstm` network through `MultiLayerNetwork.fit` (on CUDA the LSTM
layers run the fused cell kernel at every step); decoding keeps the
recurrent state as explicit (h, c) tensors per layer and steps the
concat-form cell `LSTMLayer.step`, as the JAX package does. Temperature
sampling draws with `nd/random.py`, the port of `jax.random`'s threefry
split and categorical draw, so its key stream is the JAX package's bit for
bit. `generate` is `sample` through the infer cache's prefill and decode
programs (on CUDA, captured graphs). Beams ride the batch dimension, so
every candidate advances in one step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.zoo import char_lstm
from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nn.conf import LayerType
from deeplearning4j_tpu_torch.nn.layers import get_layer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


class CharLSTM:
    """`device=None` is CUDA (raises without a GPU); pass "cpu" to run on
    the CPU."""

    def __init__(self, hidden: int = 128, n_layers: int = 1,
                 seq_len: int = 32, lr: float = 0.1, iterations: int = 50,
                 seed: int = 0, batch_size: Optional[int] = None,
                 device=None):
        self.hidden = hidden
        self.n_layers = n_layers
        self.seq_len = seq_len
        self.lr = lr
        self.iterations = iterations
        self.seed = seed
        # None trains every window as one batch; an int cuts the windows
        # into batches of that many, each one `fit` call
        self.batch_size = batch_size
        self.device = device
        self.char_index: Dict[str, int] = {}
        self.chars: List[str] = []
        self.net: Optional[MultiLayerNetwork] = None

    # -- data
    def _encode(self, text: str) -> np.ndarray:
        return np.asarray([self.char_index[c] for c in text], np.int32)

    def fit(self, text: str) -> "CharLSTM":
        self.chars = sorted(set(text))
        self.char_index = {c: i for i, c in enumerate(self.chars)}
        v = len(self.chars)
        ids = self._encode(text)
        if len(ids) < self.seq_len + 1:
            raise ValueError(
                f"text too short for seq_len={self.seq_len}: need at least "
                f"{self.seq_len + 1} chars, got {len(ids)}")
        n_win = max(1, (len(ids) - 1) // self.seq_len)
        xs = ids[:n_win * self.seq_len].reshape(n_win, self.seq_len)
        ys = ids[1:n_win * self.seq_len + 1].reshape(-1)
        eye = np.eye(v, dtype=np.float32)
        conf = char_lstm(v, hidden=self.hidden, n_layers=self.n_layers,
                         lr=self.lr, iterations=self.iterations)
        self.net = MultiLayerNetwork(conf, device=self.device,
                                     seed=self.seed).init()
        x, y = eye[xs], eye[ys]
        bs = self.batch_size
        if bs and bs < n_win:
            from deeplearning4j_tpu_torch.datasets.dataset import DataSet
            from deeplearning4j_tpu_torch.datasets.iterator import \
                PrefetchIterator

            # label rows come window-major, T of them per window
            batches = DataSet(x, y).batch_by(bs)
            self.net.fit(PrefetchIterator(batches, device=self.net.device))
        else:
            self.net.fit(x, y)
        return self

    # -- decoding plumbing
    def _lstm_params(self):
        """(layer conf, params) of the LSTM stack and the output layer."""
        conf = self.net.conf
        return [(conf.conf(i), self.net.params[i])
                for i in range(conf.n_layers)]

    def _step_fn(self):
        stack = self._lstm_params()
        lstm = get_layer(LayerType.LSTM)
        out_impl = get_layer(LayerType.OUTPUT)

        @torch.inference_mode()
        def step(x_onehot, hs, cs):
            """One char step. x_onehot [B, V]; hs, cs: per layer [B, H]."""
            h_new, c_new = [], []
            inp = x_onehot
            for li, (c, p) in enumerate(stack[:-1]):
                h, c_ = lstm.step(p, c, inp, hs[li], cs[li])
                h_new.append(h)
                c_new.append(c_)
                inp = h
            out_conf, out_p = stack[-1]
            probs = out_impl.forward(out_p, out_conf, inp)
            return torch.log(torch.clamp(probs, 1e-9, 1.0)), h_new, c_new

        return step

    def _init_state(self, batch: int):
        n_lstm = len(self._lstm_params()) - 1
        dev = self.net.device
        hs = [torch.zeros((batch, self.hidden), device=dev)
              for _ in range(n_lstm)]
        cs = [torch.zeros((batch, self.hidden), device=dev)
              for _ in range(n_lstm)]
        return hs, cs

    def _eye(self):
        return torch.eye(len(self.chars), device=self.net.device)

    def _feed(self, step, text: str, hs, cs):
        eye = self._eye()
        logp = None
        for cid in self._encode(text):
            logp, hs, cs = step(eye[int(cid)][None].repeat(hs[0].shape[0], 1),
                                hs, cs)
        return logp, hs, cs

    # -- public decode APIs
    def sample(self, seed_text: str, n: int = 50,
               temperature: float = 1.0, rng_seed: int = 0) -> str:
        """Temperature sampling, one char at a time (greedy at
        `temperature <= 0`). The key is split before every char, as in the
        JAX package: `key, sub = split(key)`, then
        `categorical(sub, logp / temperature)`."""
        assert self.net is not None, "fit() first"
        step = self._step_fn()
        hs, cs = self._init_state(1)
        logp, hs, cs = self._feed(step, seed_text, hs, cs)
        key = nd_random.prng_key(rng_seed, self.net.device)
        # a tensor, so that the division is a true one on the card too (a
        # Python divisor becomes a product by its reciprocal there), as in
        # the cached programs' `logp / temps`
        temp = torch.tensor(float(temperature), device=self.net.device)
        eye = self._eye()
        out = []
        for _ in range(n):
            key, sub = nd_random.split(key)
            if temperature <= 0:
                cid = int(torch.argmax(logp[0]))
            else:
                cid = int(nd_random.categorical(sub, logp[0] / temp))
            out.append(self.chars[cid])
            logp, hs, cs = step(eye[cid][None], hs, cs)
        return "".join(out)

    def generate(self, seed_text: str, n: int = 50,
                 temperature: float = 0.0, rng_seed: int = 0,
                 max_seq: Optional[int] = None) -> str:
        """`sample()` through the infer cache's programs: one prefill takes
        the seed text, then one decode step a char (on CUDA, replays of
        captured graphs). The same chars as `sample()` for the same
        arguments: both split one key stream, and the prefill steps the
        same concat-form cell. The decode state is the infer cache's own
        for (1 row, max_seq), zeroed first, so later calls replay the
        graphs the first one captured."""
        assert self.net is not None, "fit() first"
        ids = self._encode(seed_text)
        if len(ids) == 0:
            raise ValueError("seed_text must be non-empty")
        if max_seq is None:
            max_seq = max(8, 1 << (len(ids) + n - 1).bit_length())
        bucket = max(4, 1 << (len(ids) - 1).bit_length())
        net, ic = self.net, self.net.infer_cache
        state = ic.decode_state(net.conf, 1, max_seq, net.device,
                                role="generate")
        ic.reset_state(state)
        prompt = np.zeros((1, bucket), np.int32)
        prompt[0, :len(ids)] = ids
        keys = nd_random.prng_key(rng_seed, net.device)[None]
        temps = np.full((1,), float(temperature), np.float32)
        tok, keys, state = ic.prefill(net.conf, net.params, state, prompt,
                                      np.asarray([len(ids)], np.int32),
                                      keys, temps)
        out = [self.chars[int(tok[0])]]
        pos = np.asarray([len(ids)], np.int32)
        for _ in range(n - 1):
            tok, keys, state = ic.decode(net.conf, net.params, state, tok,
                                         pos, keys, temps)
            out.append(self.chars[int(tok[0])])
            pos = pos + 1
        return "".join(out)

    def beam_search(self, seed_text: str, n: int = 20,
                    beam_width: int = 4) -> Tuple[str, float]:
        """Beam-search decode: the best continuation and its total
        log-probability."""
        assert self.net is not None, "fit() first"
        step = self._step_fn()
        v = len(self.chars)
        # more beams than characters would leave state rows without a
        # candidate on the next step
        beam_width = min(beam_width, v)
        eye = self._eye()
        hs, cs = self._init_state(1)
        logp, hs, cs = self._feed(step, seed_text, hs, cs)

        lp0 = logp[0].float().cpu().numpy()
        top = np.argsort(-lp0, kind="stable")[:beam_width]
        beams = [([int(t)], float(lp0[int(t)])) for t in top]
        hs = [h.repeat(beam_width, 1) for h in hs]
        cs = [c.repeat(beam_width, 1) for c in cs]

        for _ in range(n - 1):
            x = eye[torch.as_tensor([b[0][-1] for b in beams],
                                    device=eye.device)]
            logp, hs_n, cs_n = step(x, hs, cs)
            lp = logp.float().cpu().numpy()
            # expand: beam_width x V candidates, keep the best beam_width
            cand = []
            for bi, (seq, score) in enumerate(beams):
                for cid in np.argsort(-lp[bi])[:beam_width]:
                    cand.append((seq + [int(cid)],
                                 score + float(lp[bi][int(cid)]), bi))
            cand.sort(key=lambda t: -t[1])
            cand = cand[:beam_width]
            beams = [(seq, score) for seq, score, _ in cand]
            keep = torch.as_tensor([bi for _, _, bi in cand],
                                   device=eye.device)
            hs = [h[keep] for h in hs_n]
            cs = [c[keep] for c in cs_n]

        best_seq, best_score = beams[0]
        return "".join(self.chars[i] for i in best_seq), best_score
