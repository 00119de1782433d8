"""Char-LSTM language model: training, greedy sampling and beam search.

Counterpart of `deeplearning4j_tpu/models/char_lstm.py`. Training is the
`zoo.char_lstm` network through `MultiLayerNetwork.fit` (on CUDA the LSTM
layers run the fused cell kernel at every step); decoding keeps the
recurrent state as explicit (h, c) tensors per layer and steps the
concat-form cell `LSTMLayer.step`, as the JAX package does. Beams ride the
batch dimension, so every candidate advances in one step.

Not ported yet (ROADMAP.md queue A item 8, generation): temperature
sampling (the JAX package's `jax.random.categorical` draws cannot be
reproduced, so how the port samples is that item's decision) and
`generate`, which needs the compiled decode cache.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.zoo import char_lstm
from deeplearning4j_tpu_torch.nn.conf import LayerType
from deeplearning4j_tpu_torch.nn.layers import get_layer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

_GENERATION = ("is not ported to deeplearning4j_tpu_torch yet; see "
               "ROADMAP.md queue A item 8 (generation)")


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
        """Greedy decoding (`temperature <= 0`), one char at a time."""
        assert self.net is not None, "fit() first"
        if temperature > 0:
            raise NotImplementedError(f"temperature sampling {_GENERATION}")
        step = self._step_fn()
        hs, cs = self._init_state(1)
        logp, hs, cs = self._feed(step, seed_text, hs, cs)
        eye = self._eye()
        out = []
        for _ in range(n):
            cid = int(torch.argmax(logp[0]))
            out.append(self.chars[cid])
            logp, hs, cs = step(eye[cid][None], hs, cs)
        return "".join(out)

    def generate(self, seed_text: str, n: int = 50,
                 temperature: float = 0.0, rng_seed: int = 0,
                 max_seq: Optional[int] = None) -> str:
        raise NotImplementedError(f"CharLSTM.generate {_GENERATION}")

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
