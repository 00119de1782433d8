"""Threefry keys and the draws of temperature sampling, as JAX makes them.

The JAX package samples tokens with `jax.random.split` and
`jax.random.categorical` on `[B, 2]` uint32 keys (its
`optimize/infer_cache.py` `_sample_tokens`, `models/char_lstm.py`
`sample`). This module computes the same functions with integer tensor ops
(int64 tensors holding uint32 values, masked after every add), so that a
captured CUDA graph can hold them and the keys come out bit for bit what
the JAX package's are, on the CPU and on the card. It reproduces the
defaults of JAX 0.9: the `threefry2x32` implementation with
`jax_threefry_partitionable` on, and the "low" Gumbel mode.

- `threefry2x32`: the Threefry-2x32 hash (20 rounds, JAX's rotations and
  key schedule);
- `prng_key(seed)`: `jax.random.PRNGKey(seed)`, [0, seed mod 2^32] (the
  high word is 0 without x64);
- `split(keys, num)`: `jax.random.split`, key i of a split is
  `threefry2x32(key, (0, i))`;
- `random_bits(keys, n)`: 32-bit draws, `y1 ^ y2` of the hash of the
  counts (0, j), j < n;
- `uniform(keys, n, minval, maxval)`: the float32 uniform built from the
  top 23 bits of each draw;
- `gumbel`, `categorical`: `-log(-log(u))` with u uniform on [tiny, 1), and
  the argmax of gumbel + logits;
- `fold_in(key, data)`: `jax.random.fold_in`, `threefry2x32(key, (0,
  data))` (the RBM's Gibbs chain folds in the step number);
- `bernoulli`, `dropout_mask`, `binomial`, `normal` and `KeyStream`, the
  JAX package's `nd/random.py` (dropout's masks, the denoising
  autoencoder's corruption, the RBM's unit samples and host-side key
  streams): `bernoulli(key, p, shape)` is `uniform(key,
  prod(shape)).reshape(shape) < p`, JAX's "low" mode; with a tensor p (the
  RBM's sigmoid means) the shape is p's and the uniforms are compared with
  p element by element;
- `categorical_joint(key, logits)`: `jax.random.categorical(key, logits)`
  with ONE key for the whole [..., V] array (one Gumbel field of that
  shape), as the RBM's softmax units draw; `categorical` takes one key a
  row;
- `split_host`: `split` of one key held as two Python ints, for host-side
  streams (`MultiLayerNetwork`'s key), with no tensor op at all;
- `uniform_dtype`, `normal_dtype`: `jax.random.uniform(key, shape, dtype,
  minval, maxval)` and `jax.random.normal(key, shape, dtype)` for one key
  in float32, bfloat16 or float16, the draws of the initial params
  (`nn/weights.py`): a 16-bit float takes 8 (bfloat16) or 16 (float16) bits
  of each draw for its mantissa, as JAX's `_uniform` does.

Keys are int64 tensors of shape [..., 2] whose values lie in [0, 2^32).
Every function works on a batch of keys at once (the leading axes), the way
the JAX package `vmap`s them. The float steps (`log`, the argmax of sums)
may round differently from XLA's in the last place, so a draw can differ
from JAX's only where two candidates tie to within that rounding.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32's smallest normal number: the low end of the Gumbel's uniform
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash of the counts (x1, x2) under the key
    (k1, k2): int64 tensors (or ints) of uint32 values that broadcast
    together. Returns (y1, y2), int64 tensors of uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: an int64 [2] tensor [0, seed mod 2^32]."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def key_array(keys, device=None) -> torch.Tensor:
    """Keys given as uint32 numpy arrays (the JAX package's form) or
    tensors, as an int64 tensor on `device`."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64),
                           device=device)


def _hash_counts(keys: torch.Tensor, n: int):
    """threefry2x32 of each key [..., 2] over the counts (0, j), j < n:
    (y1, y2), each [..., n]."""
    j = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(j),
                        j)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split` of each key [..., 2]: [..., num, 2]."""
    y1, y2 = _hash_counts(keys, num)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`n` 32-bit draws of each key [..., 2]: int64 [..., n]."""
    y1, y2 = _hash_counts(keys, n)
    return y1 ^ y2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, (n,), float32, minval, maxval)` for each key
    [..., 2]: float32 [..., n]. The top 23 bits of a draw fill the mantissa
    of a float in [1, 2), minus 1, then `floats * (maxval - minval) +
    minval`, which XLA fuses into one multiply-add: here the product is
    exact in float64 and the sum is rounded once to float64, then to
    float32 (the two roundings can differ from the fused one's in about one
    case in 2^29; at the Gumbel's [tiny, 1) the span is 1 and they never
    do)."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)  # rounded in float32, as in JAX
    out = (floats.double() * span + float(lo)).float()
    return torch.clamp_min(out, float(lo))


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.gumbel(key, (n,), float32)` ("low" mode) for each key:
    -log(-log(u)), u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` over the last axis, one key a
    row: keys [..., 2], logits [..., V] float32. Returns int64 [...]."""
    g = gumbel(keys, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)


def categorical_joint(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis=-1)` for one key [2] and
    logits of any shape [..., V]: one Gumbel draw of logits' whole shape
    (counts in row-major order), added to the logits, argmax over the last
    axis. Returns int64 [...]."""
    g = gumbel(key, logits.numel()).reshape(logits.shape)
    return torch.argmax(g + logits, dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for keys [..., 2] and a 32-bit int:
    the hash of the counts (0, data) under the key, as `split`'s key
    `data` is."""
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], 0, int(data) & _MASK)
    return torch.stack([y1, y2], dim=-1)


def sample_tokens(logp: torch.Tensor, keys: torch.Tensor,
                  temps: torch.Tensor):
    """One token a row with the JAX package's key discipline
    (`optimize/infer_cache.py` `_sample_tokens`): every row splits its key
    once (`key, sub = split(key)`); rows with temperature <= 0 take the
    argmax, the rest draw `categorical(sub, logp / temperature)`. logp
    [B, V] float32, keys [B, 2], temps [B] float32. Returns (tok [B] int32,
    the advanced keys [B, 2]). Pure tensor ops: a CUDA graph holds it."""
    ks = split(keys)
    new_keys, subs = ks[:, 0], ks[:, 1]
    greedy = torch.argmax(logp, dim=-1)
    hot = temps > 0
    safe = torch.where(hot, temps, torch.ones_like(temps))
    sampled = categorical(subs, logp / safe[:, None])
    return torch.where(hot, sampled, greedy).to(torch.int32), new_keys


def split_host(key, num: int = 2) -> list:
    """`jax.random.split` of one key given as two ints (or any pair of
    uint32 values): `num` keys, each a tuple of two ints. The hash runs on
    Python ints, so a host-side stream costs no tensor op."""
    k1, k2 = (int(v) & _MASK for v in key)
    return [tuple(threefry2x32(k1, k2, 0, i)) for i in range(num)]


class KeyStream:
    """Host-side sequential keys, as the JAX package's `KeyStream`: each
    `next()` splits the stream's key once and hands out the second half,
    an int64 [2] tensor on `device`."""

    def __init__(self, seed: int = 123, device=None):
        self._key = (0, int(seed) & _MASK)
        self.device = device

    def next(self) -> torch.Tensor:
        self._key, sub = split_host(self._key)
        return torch.tensor(sub, dtype=torch.int64, device=self.device)

    def __call__(self) -> torch.Tensor:
        return self.next()


def _numel(shape) -> int:
    return int(np.prod(tuple(shape), dtype=np.int64))


def bernoulli(key: torch.Tensor, p, shape=None) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` for one key [2]: a bool tensor
    of `shape`, each entry uniform < p with p rounded to float32, as JAX
    compares them. With p a float32 tensor (shape None) the draw has p's
    shape and each uniform is compared with its own p."""
    if isinstance(p, torch.Tensor):
        return uniform(key, p.numel()).reshape(p.shape) < p
    u = uniform(key, _numel(shape))
    return (u < float(np.float32(p))).reshape(tuple(shape))


def binomial(key: torch.Tensor, p: float, shape,
             dtype=torch.float32) -> torch.Tensor:
    """A single-trial binomial (Bernoulli(p)) draw as floats in {0, 1}."""
    return bernoulli(key, p, shape).to(dtype)


#: the coefficients of XLA's single-precision erfinv (M. Giles, "Approximating
#: the erfinv function"), for w < 5 and w >= 5
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
              1.00167406, 2.83297682)


def _horner(coeffs, w: torch.Tensor) -> torch.Tensor:
    """The polynomial in float32 with a fused multiply-add a step (the
    product exact in float64, one rounding to float32)."""
    p = torch.full_like(w, float(np.float32(coeffs[0])))
    wd = w.double()
    for c in coeffs[1:]:
        p = (p.double() * wd + float(np.float32(c))).float()
    return p


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as XLA computes it: Giles' polynomials in
    w = -log1p(-x^2). Within 3 ulps of JAX's on the CPU (log1p's last
    place), equal in ~99 % of draws; `torch.erfinv` is up to ~90 ulps
    away in the tails."""
    x = x.float()
    w = -torch.log1p(-x * x)
    p = torch.where(w < 5.0, _horner(_ERFINV_LO, w - 2.5),
                    _horner(_ERFINV_HI, torch.sqrt(w) - 3.0))
    return p * x


def normal(key: torch.Tensor, mean: float, std: float, shape,
           dtype=torch.float32) -> torch.Tensor:
    """`mean + std * jax.random.normal(key, shape)`: sqrt(2) * erfinv(u)
    with u uniform on (-1, 1), as JAX draws it (`erfinv`: within a few
    ulps of XLA's)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, _numel(shape), lo, 1.0).reshape(tuple(shape))
    z = float(np.float32(np.sqrt(2.0))) * erfinv(u)
    return (mean + std * z).to(dtype)


def dropout_mask(key: torch.Tensor, keep_prob: float, shape,
                 dtype=torch.float32, rows=None) -> torch.Tensor:
    """The inverted-dropout mask of the JAX package: `bernoulli(key,
    keep_prob, shape)` in `dtype`, divided by keep_prob rounded to `dtype`
    (a 0-d tensor, so that a bf16 mask divides by bf16(keep_prob) as JAX's
    does), so inference needs no rescale. `rows` = (offset, total): the
    mask's leading dim is rows [offset, offset + shape[0]) of a batch of
    `total` rows, whose one mask is drawn and cut (a rank's shard of a
    batch that the JAX package masks in one draw)."""
    shape = tuple(shape)
    if rows is None:
        keep = bernoulli(key, keep_prob, shape)
    else:
        offset, total = rows
        keep = bernoulli(key, keep_prob, (total,) + shape[1:])[
            offset:offset + shape[0]]
    return keep.to(dtype) / torch.tensor(keep_prob, dtype=dtype)


#: (mantissa bits, random bits a draw keeps, the bits of 1.0) of the 16-bit
#: floats: JAX's `_uniform` draws 8 bits where a mantissa is narrower
_HALF = {torch.bfloat16: (7, 8, 0x3F80), torch.float16: (10, 16, 0x3C00)}


def uniform_dtype(key: torch.Tensor, shape, dtype=torch.float32,
                  minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)` for one key
    [2]. float32 is `uniform`; a 16-bit float fills its mantissa from the
    low 8 (bfloat16) or 16 (float16) bits of each draw and scales as XLA
    does on the CPU: bfloat16 rounding after each op, float16 in float32
    from its span in float16. float64 draws float32 values (JAX without
    x64)."""
    shape = tuple(int(d) for d in shape)
    n = _numel(shape)
    if dtype not in _HALF:
        out = uniform(key, n, minval, maxval).reshape(shape)
        return out.to(dtype)
    nmant, width, one = _HALF[dtype]
    bits = random_bits(key, n) & ((1 << width) - 1)
    half = ((bits >> (width - nmant)) | one).to(torch.int16).view(dtype)
    lo, hi = (torch.tensor(v, dtype=dtype, device=half.device)
              for v in (minval, maxval))
    if dtype is torch.bfloat16:
        # one rounding to bfloat16 an op, as XLA computes it
        out = (half - 1.0) * (hi - lo) + lo
    else:
        # float16: the span in float16, the rest in float32, rounded once
        out = ((half.float() - 1.0) * (hi - lo).float()
               + lo.float()).to(dtype)
    return torch.maximum(out, lo).reshape(shape)


def normal_dtype(key: torch.Tensor, shape, dtype=torch.float32
                 ) -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)` for one key [2]: sqrt(2) *
    erfinv(u), u uniform on (-1, 1) in `dtype` (`erfinv` within a few
    float32 ulps of XLA's)."""
    if dtype not in _HALF:
        return normal(key, 0.0, 1.0, shape).to(dtype)
    # nextafter(-1, 0) in dtype: the spacing below 1 is 2^-(nmant + 1)
    lo = -(1.0 - 2.0 ** -(_HALF[dtype][0] + 1))
    u = uniform_dtype(key, shape, dtype, lo, 1.0)
    z = erfinv(u).to(dtype)
    return z * torch.tensor(float(np.sqrt(2.0)), dtype=dtype)
