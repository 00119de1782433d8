"""LSTM layers: one fused gate matrix, a time loop, and the fused cell kernel.

Counterpart of `deeplearning4j_tpu/nn/layers/lstm.py`. The four gates stay
fused in one [(n_in + n_out), 4 * n_out] matrix `W` with gate order
[i | f | o | g] and one bias `b` (forget-gate bias 1 at init), so a step is
one product. Inputs are [batch, time, n_in] (or one [time, n_in] sequence);
outputs the hidden states [batch, time, n_out].

Two forward paths, chosen by `conf.lstm_impl`:
- "fused": one launch of the hand-written cell kernel per time step
  (`nd/kernels.fused_lstm_step`; both products, the gates and the state
  update in one kernel), with `Wx` and `Wh` the two row blocks of `W` as
  views, so autograd returns their gradients to `W`;
- "scan": the hoisted scan, the input half of the product taken for every
  step at once up front and only h.Wh left in the loop.
BPTT is autograd through the loop. Decoding (`step`) and the prompt phase
of cached generation (`prefill`) are the concat form `[x, h].W + b`, as in
the JAX package.

Mixed dtypes (the serve policies' bfloat16 weights under a float32 input or
carry): the scan and the concat form take each product in the wider of its
operands' dtypes (`base.promoted_matmul`), as JAX promotes. The cell kernel
takes one dtype, so the fused path casts the input to the weights' dtype
and runs its carries there: a policy's bfloat16 weights run the bfloat16
cell.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nd.kernels import fused_lstm_step
from deeplearning4j_tpu_torch.nn.layers.base import (_sampler, param_dtype,
                                                     promoted_matmul)
from deeplearning4j_tpu_torch.nn.weights import init_weights


class LSTMLayer:
    @staticmethod
    def init(key, conf):
        n_in, n_h = conf.n_in, conf.n_out
        W = init_weights(key, (n_in + n_h, 4 * n_h), conf.weight_init,
                         _sampler(conf), param_dtype(conf))
        b = torch.zeros((4 * n_h,), dtype=param_dtype(conf),
                        device=key.device)
        b[n_h:2 * n_h] = 1.0  # forget-gate bias 1
        return {"W": W, "b": b}

    @staticmethod
    def _step(params, n_h, carry, x_t):
        h, _ = carry
        z = promoted_matmul(torch.cat([x_t, h], dim=-1),
                            params["W"]) + params["b"]
        return LSTMLayer._gates(n_h, carry, z)

    @staticmethod
    def _gates(n_h, carry, z):
        """Gate math given the pre-activation z = x.Wx + h.Wh + b."""
        _, c = carry
        i = torch.sigmoid(z[..., :n_h])
        f = torch.sigmoid(z[..., n_h:2 * n_h])
        o = torch.sigmoid(z[..., 2 * n_h:3 * n_h])
        g = torch.tanh(z[..., 3 * n_h:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        return (h, c), h

    @staticmethod
    def _use_fused(conf, x) -> bool:
        # "auto" is the kernel on a CUDA tensor and the hoisted scan on the
        # CPU, as the JAX package's is off the TPU. On the H100 the kernel
        # wins both entry points on the default (captured) path, so one
        # rule serves both: at the bench's char-LSTM a captured train step
        # takes 49.5-49.8 ms fused against 55.6-55.9 ms scan, and a
        # captured `output` 4.2-4.3 ms against 9.3-9.5 ms (chip_smoke.py's
        # lstm_train turns, PERF.md). The JAX package's TPU measurement
        # (lstm.py:57-63, Pallas cell vs scan on v5e) does not carry over.
        impl = getattr(conf, "lstm_impl", "auto")
        if impl == "auto":
            return x.is_cuda
        return impl == "fused"

    @staticmethod
    def forward(params, conf, x, key=None, training=False):
        """x: [batch, time, n_in] -> hidden states [batch, time, n_out]. No
        dropout (as in the JAX package): key and training are ignored."""
        if x.dim() == 2:  # one sequence [time, n_in]
            return LSTMLayer.forward(params, conf, x[None])[0]
        bsz, steps, _ = x.shape
        n_h, n_in = conf.n_out, conf.n_in
        if LSTMLayer._use_fused(conf, x):
            # the kernel's operands share one dtype: the weights'
            x = x.to(params["W"].dtype)
        h = x.new_zeros((bsz, n_h))
        c = x.new_zeros((bsz, n_h))
        if LSTMLayer._use_fused(conf, x):
            wx, wh = params["W"][:n_in], params["W"][n_in:]
            hs = []
            for t in range(steps):
                h, c = fused_lstm_step(x[:, t], h, c, wx, wh, params["b"])
                hs.append(h)
            return torch.stack(hs, dim=1)
        return LSTMLayer._hoisted_scan(
            params, n_in, x, h, c,
            lambda carry, z: LSTMLayer._gates(n_h, carry, z))

    @staticmethod
    def _hoisted_scan(params, n_in, x, h0, c0, gates):
        """The scan path of LSTM and GravesLSTM: the input half of the gate
        product for every step in one [B*T, n_in].[n_in, 4H] matmul up front
        (plus the bias), leaving h.Wh in the loop. The concat form's math,
        reassociated. `gates`: (carry, z) -> ((h, c), h)."""
        wh = params["W"][n_in:]
        # [B, T, 4H]
        z_x = promoted_matmul(x, params["W"][:n_in]) + params["b"]
        carry, hs = (h0, c0), []
        for t in range(x.shape[1]):
            carry, h = gates(carry, z_x[:, t] + promoted_matmul(carry[0], wh))
            hs.append(h)
        return torch.stack(hs, dim=1)

    @staticmethod
    def step(params, conf, x_t, h, c):
        """One decode step (sampling, beam search)."""
        (h, c), _ = LSTMLayer._step(params, conf.n_out, (h, c), x_t)
        return h, c

    @classmethod
    def prefill(cls, params, conf, x, h0, c0, length):
        """The prompt phase of cached generation: the prompt stepped
        through the concat form `cls._step`, the math `step()` runs a token
        at a time (not the hoisted scan, not the cell kernel), so the carry
        is bitwise what repeated `step()` calls give. A row's carry freezes
        at t >= length[row], so bucket padding never advances it.

        x: [B, T, n_in]; length: [B] int tensor. Returns (hs [B, T, n_out],
        h [B, n_out], c [B, n_out])."""
        n_h = conf.n_out
        carry, hs = (h0, c0), []
        for t in range(x.shape[1]):
            (h2, c2), _ = cls._step(params, n_h, carry, x[:, t])
            live = (length > t)[:, None]
            carry = (torch.where(live, h2, carry[0]),
                     torch.where(live, c2, carry[1]))
            hs.append(carry[0])
        return torch.stack(hs, dim=1), carry[0], carry[1]


class GravesLSTMLayer(LSTMLayer):
    """LSTM with diagonal peepholes (Graves 2013, eq. 7-11): the input and
    forget gates see the previous cell state, the output gate the new one.
    The kernel has no peephole terms, so this layer always takes the hoisted
    scan."""

    @staticmethod
    def init(key, conf):
        params = LSTMLayer.init(key, conf)
        n_h = conf.n_out
        for name in ("p_i", "p_f", "p_o"):
            # zero at init: the layer starts as the plain LSTM
            params[name] = torch.zeros((n_h,), dtype=param_dtype(conf),
                                       device=key.device)
        return params

    @staticmethod
    def _step(params, n_h, carry, x_t):
        h, _ = carry
        z = promoted_matmul(torch.cat([x_t, h], dim=-1),
                            params["W"]) + params["b"]
        return GravesLSTMLayer._gates(params, n_h, carry, z)

    @staticmethod
    def _gates(params, n_h, carry, z):
        _, c = carry
        i = torch.sigmoid(z[..., :n_h] + params["p_i"] * c)
        f = torch.sigmoid(z[..., n_h:2 * n_h] + params["p_f"] * c)
        g = torch.tanh(z[..., 3 * n_h:])
        c_new = f * c + i * g
        o = torch.sigmoid(z[..., 2 * n_h:3 * n_h] + params["p_o"] * c_new)
        h = o * torch.tanh(c_new)
        return (h, c_new), h

    @staticmethod
    def forward(params, conf, x, key=None, training=False):
        if x.dim() == 2:
            return GravesLSTMLayer.forward(params, conf, x[None])[0]
        bsz = x.shape[0]
        n_h = conf.n_out
        return LSTMLayer._hoisted_scan(
            params, conf.n_in, x, x.new_zeros((bsz, n_h)),
            x.new_zeros((bsz, n_h)),
            lambda carry, z: GravesLSTMLayer._gates(params, n_h, carry, z))

    @staticmethod
    def step(params, conf, x_t, h, c):
        (h, c), _ = GravesLSTMLayer._step(params, conf.n_out, (h, c), x_t)
        return h, c
