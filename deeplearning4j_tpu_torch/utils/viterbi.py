"""Viterbi sequence decoder on the device.

Counterpart of `deeplearning4j_tpu/utils/viterbi.py` (reference
`util/Viterbi.java`: the most likely state sequence given per-step
observation log-likelihoods and a transition model). The JAX package runs
two `lax.scan`s, a max-product forward over time and a backtrack over the
argmax pointers; here both are loops over T of tensor ops on the decoder's
device, and `decode` reads the path and its log-probability back to the
host once, at the end.

The arithmetic is the JAX package's, in float32 (JAX without x64 takes
float64 inputs as float32): scores[i, j] = delta[i] + trans[i, j], then
max and argmax over i, then + obs[t]. `torch.argmax`, like `jnp.argmax`,
takes the first of several maximal entries, so ties break alike.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd.platform import resolve_device


def viterbi_decode(log_init: torch.Tensor, log_trans: torch.Tensor,
                   log_obs: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """log_init [S], log_trans [S, S] (from, to), log_obs [T, S], float32
    on one device -> (path [T] int64, best log prob, a 0-d tensor), both
    on that device; nothing is read back."""
    delta = log_init + log_obs[0]
    back = []
    for t in range(1, log_obs.shape[0]):
        scores = delta[:, None] + log_trans
        back.append(torch.argmax(scores, dim=0))
        delta = torch.amax(scores, dim=0) + log_obs[t]
    last = torch.argmax(delta).view(1)
    best = delta.gather(0, last)[0]
    path = [last]
    for back_t in reversed(back):
        path.append(back_t.gather(0, path[-1]))  # the state at t - 1
    return torch.cat(path[::-1]), best


class Viterbi:
    """`Viterbi(possibleLabels)` facade over `viterbi_decode`, on `device`
    (CUDA unless the caller passes "cpu")."""

    def __init__(self, n_states: int, log_init=None, log_trans=None,
                 device=None):
        self.n_states = n_states
        self.device = resolve_device(device)
        self.log_init = self._f32(np.zeros(n_states) if log_init is None
                                  else log_init)
        self.log_trans = self._f32(np.zeros((n_states, n_states))
                                   if log_trans is None else log_trans)

    def _f32(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def decode(self, log_obs) -> tuple:
        """log_obs (T, S) per-step log-likelihoods -> (path (T,) int64
        ndarray, best log prob), read back in one copy."""
        path, best = viterbi_decode(self.log_init, self.log_trans,
                                    self._f32(log_obs))
        # float64 holds every state index and the float32 best exactly
        host = torch.cat([path.double(), best.double().view(1)]).cpu()
        return host[:-1].long().numpy(), float(host[-1])

    def decode_from_probs(self, probs) -> tuple:
        """Convenience over raw (T, S) probabilities (reference passes
        network outputs)."""
        p = torch.clamp_min(self._f32(probs), 1e-30)
        return self.decode(torch.log(p))
