"""The port's attention kernels and plain versions vs the JAX package.

The flash kernel's plain version (what the wrapper runs on CPU tensors) is
held to the JAX package's Pallas kernel run in interpret mode, lse residual
included, at the tolerance of tests/test_pallas_kernels.py (2e-5, f32).
The plain versions of the three backward kernels (delta, dK/dV, dQ) and
`FlashAttentionFunction`'s gradients are held to `_flash_fused_bwd_impl`
and `jax.grad` in interpret mode at 1e-5 (f32), the tolerance of
tests/test_mfu_paths.py.
Inputs come from a numpy seed and cross as numpy arrays. The CUDA kernel
itself runs only on a GPU: those tests carry the `cuda` marker and skip
here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nd import attention as jax_attention  # noqa: E402
from deeplearning4j_tpu.nd.pallas_kernels import (  # noqa: E402
    _flash_attention_fwd_impl, _flash_fused_bwd_impl,
    flash_attention as jax_flash_attention)
from deeplearning4j_tpu_torch.nd import attention, kernels  # noqa: E402

TOL = 2e-5


def _qkv(seed, b, s, h, d, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, s, h, d)).astype(dtype)
            for _ in range(3)]


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_reference_matches_pallas_kernel(causal):
    q, k, v = _qkv(0, 2, 32, 2, 8)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal, 8, 8, True)
    got = kernels.flash_attention(*_torch(q, k, v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_reference_lse_matches_pallas_residual(causal):
    q, k, v = _qkv(1, 2, 32, 2, 16)
    want_o, want_lse = _flash_attention_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 16, 8, True,
        with_lse=True)
    got_o, got_lse = kernels.flash_attention(*_torch(q, k, v), causal,
                                             with_lse=True)
    assert got_lse.shape == (2 * 2, 32, 1) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_reference_ragged_matches_jax_fallback(causal):
    # S=20 is ragged for 8-wide tiles: the JAX package falls back to its
    # blockwise loop there, the port's kernel masks the tail itself
    q, k, v = _qkv(2, 2, 20, 2, 8)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal, 8, 8, True)
    got = kernels.flash_attention(*_torch(q, k, v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_flash_reference_bf16_matches_pallas_kernel():
    q, k, v = _qkv(3, 2, 16, 2, 8)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_flash_attention(qb, kb, vb, True, 8, 8, True)
    got = kernels.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16),
                                  True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["full", "blockwise"])
def test_plain_attention_matches_jax(impl, causal):
    q, k, v = _qkv(4, 2, 12, 2, 8)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = _torch(q, k, v)
    if impl == "full":
        want = jax_attention.full_attention(jq, jk, jv, causal=causal)
        got = attention.full_attention(tq, tk, tv, causal=causal)
    else:  # block 5 leaves a ragged tail block of 2
        want = jax_attention.blockwise_attention(jq, jk, jv, block_size=5,
                                                 causal=causal)
        got = attention.blockwise_attention(tq, tk, tv, block_size=5,
                                            causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_flash_wrapper_takes_views_of_a_fused_projection():
    # the attention layer hands the wrapper views of one [B, S, 3n] tensor
    rng = np.random.RandomState(5)
    qkv = torch.from_numpy(rng.standard_normal((2, 10, 48)).astype(
        np.float32))
    q, k, v = (t.view(2, 10, 2, 8) for t in qkv.split(16, dim=-1))
    assert not q.is_contiguous()
    got = kernels.flash_attention(q, k, v, True)
    want = kernels.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    kernels.reset_launches()
    q, k, v = _torch(*_qkv(6, 1, 8, 1, 8))
    kernels.flash_attention(q, k, v, True)
    assert set(kernels.LAUNCHES) == set(kernels.KERNELS)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_every_kernel_has_a_source_and_a_count():
    import os

    for src in kernels.SOURCES.values():
        assert os.path.exists(os.path.join(kernels._CSRC, src))
    for name, lib in kernels.KERNELS.items():
        assert lib in kernels.SOURCES
        assert name in kernels.LAUNCHES
    assert set(kernels.KERNELS.values()) == set(kernels.SOURCES)


def test_library_path_follows_the_headers_a_source_includes(tmp_path):
    # a changed header under csrc/ must build a new library, not load the
    # stale one
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels._CSRC, csrc)
    paths = {name: kernels._lib_path(name, str(csrc), str(tmp_path))
             for name in kernels.SOURCES}
    assert paths == {name: kernels._lib_path(name, str(csrc), str(tmp_path))
                     for name in kernels.SOURCES}
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// changed\n")
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        assert kernels._lib_path(name, str(csrc), str(tmp_path)) != \
            paths[name]
    # sources that do not include the changed header keep their library
    for name in ("lstm_cell", "scatter_add"):
        assert kernels._lib_path(name, str(csrc), str(tmp_path)) == \
            paths[name]
    changed = {name: kernels._lib_path(name, str(csrc), str(tmp_path))
               for name in kernels.SOURCES}
    with open(csrc / "warp_mma.cuh", "a") as f:
        f.write("\n// changed\n")
    for name in kernels.SOURCES:
        now = kernels._lib_path(name, str(csrc), str(tmp_path))
        if name in ("flash_attn_fwd", "flash_attn_bwd", "lstm_cell"):
            assert now != changed[name]
        else:
            assert now == changed[name]


def _padded_case(seed, d, view):
    """q, k, v, dO [2, 24, 3, d] float32 on the CPU, q/k/v as views of one
    fused projection (with a sequence stride that no tensor map takes)
    when `view`."""
    rng = np.random.RandomState(seed)
    b, s, h = 2, 24, 3
    if view:
        qkv = torch.from_numpy(rng.standard_normal(
            (b, s, 3 * h * d + 1)).astype(np.float32))
        q, k, v = (t.view(b, s, h, d)
                   for t in qkv[..., :3 * h * d].split(h * d, dim=-1))
    else:
        q, k, v = _torch(*_qkv(seed, b, s, h, d))
    do = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32))
    return q, k, v, do


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,view", [(20, False), (32, False), (100, False),
                                    (64, True), (20, True)])
def test_tma_padding_route_equals_the_unpadded_computation(d, view, causal):
    # the wrapper's rule for inputs a tensor map cannot describe: zero-pad
    # D to 64 or 128 in contiguous copies, keep the original D's scale, cut
    # the outputs back; through the plain versions it changes nothing
    q, k, v, do = _padded_case(21, d, view)
    scale = 1.0 / d ** 0.5
    before = kernels.PAD_COPIES
    pq, pk, pv, pdo = kernels.tma_heads(q, k, v, do)
    # every input is copied, but a contiguous dO that needs no padding
    padded = d != kernels.tma_width(d)
    assert kernels.PAD_COPIES == before + (4 if padded else 3)
    for t in (pq, pk, pv, pdo):
        assert t.shape[3] == kernels.tma_width(d) and t.is_contiguous()
        assert kernels._tma_ready(t)
        assert not t[..., d:].any()
    want_o, want_lse = kernels.flash_attention_reference(q, k, v, causal,
                                                         with_lse=True)
    got_o, got_lse = kernels.flash_attention_reference(
        pq, pk, pv, causal, with_lse=True, scale=scale)
    got_o = kernels.tma_slice(got_o, d)
    assert got_o.shape == q.shape
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), rtol=1e-6,
                               atol=1e-6)
    delta = kernels.flash_bwd_delta_reference(want_o, do)
    want_dk, want_dv = kernels.flash_bwd_dkv_reference(q, k, v, do, want_lse,
                                                       delta, causal)
    got_dk, got_dv = kernels.flash_bwd_dkv_reference(
        pq, pk, pv, pdo, want_lse, delta, causal, scale=scale)
    for got, want in ((got_dk, want_dk), (got_dv, want_dv)):
        got = kernels.tma_slice(got, d)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    # o, dk and dv are cut back where D was padded
    assert kernels.PAD_COPIES == before + (7 if padded else 3)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,view", [(20, False), (100, False), (64, True),
                                    (100, True)])
def test_tma_padding_route_keeps_dq_of_the_unpadded_computation(d, view,
                                                                 causal):
    # the dQ wrapper's route for bf16 inputs no tensor map takes: zero-padded
    # q, k, v, dO at the original D's scale give dQ's first D columns
    q, k, v, do = _padded_case(24, d, view)
    scale = 1.0 / d ** 0.5
    pq, pk, pv, pdo = kernels.tma_heads(q, k, v, do)
    o, lse = kernels.flash_attention_reference(q, k, v, causal,
                                               with_lse=True)
    delta = kernels.flash_bwd_delta_reference(o, do)
    want = kernels.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    got = kernels.flash_bwd_dq_reference(pq, pk, pv, pdo, lse, delta, causal,
                                         scale=scale)
    assert got.shape[3] == kernels.tma_width(d)
    assert not got[..., d:].any()
    got = kernels.tma_slice(got, d)
    assert got.shape == q.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_tma_route_keeps_readable_inputs_in_place():
    # the serving and training paths' layout (qkv views, D = 128) and
    # contiguous D = 64 need no copy
    rng = np.random.RandomState(22)
    qkv = torch.from_numpy(rng.standard_normal((2, 16, 3 * 2 * 128)).astype(
        np.float32)).to(torch.bfloat16)
    views = [t.view(2, 16, 2, 128) for t in qkv.split(256, dim=-1)]
    flat = _torch(*_qkv(23, 2, 16, 2, 64), dtype=torch.bfloat16)
    before = kernels.PAD_COPIES
    for ts in (views, flat):
        out = kernels.tma_heads(*ts)
        assert all(a is b for a, b in zip(out, ts))
        assert kernels.tma_slice(out[0], ts[0].shape[3]) is out[0]
    assert kernels.PAD_COPIES == before
    assert [kernels.tma_width(d) for d in (1, 63, 64, 65, 128)] == \
        [64, 64, 64, 128, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    for causal, s in ((True, 200), (False, 256)):
        q, k, v = (t.cuda() for t in _torch(*_qkv(7, 2, s, 4, 64), dtype=dt))
        before = kernels.LAUNCHES["flash_attn_fwd"]
        got_o, got_lse = kernels.flash_attention(q, k, v, causal,
                                                 with_lse=True)
        want_o, want_lse = kernels.flash_attention_reference(
            q, k, v, causal, with_lse=True)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["flash_attn_fwd"] == before + 1
        atol = 1e-4 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(got_o.float(), want_o.float(), atol=atol,
                                   rtol=1e-4)
        torch.testing.assert_close(got_lse, want_lse, atol=1e-3, rtol=1e-4)


# The reference's own f32 shapes and tolerances (atol = rtol): it holds its
# fused f32 gradients to full attention at 1e-5 at (2, 64, 2, 8) and
# (1, 128, 2, 16) (tests/test_mfu_paths.py:276-279,303) and its f32
# forward at 2e-5 (tests/test_pallas_kernels.py:25). The f32 kernels (3xTF32
# on the tensor cores) are held to their plain versions there at those
# tolerances; the 1e-4 cases above and below stay as they are.

@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 64, 2, 8), (1, 128, 2, 16)])
def test_cuda_f32_kernels_meet_the_reference_tolerances_at_its_shapes(
        shape, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    q, k, v = (t.cuda() for t in _torch(*_qkv(45, *shape)))
    do = torch.from_numpy(np.random.RandomState(46).standard_normal(
        shape).astype(np.float32)).cuda()
    o, lse = kernels.flash_attention(q, k, v, causal, with_lse=True)
    want_o, want_lse = kernels.flash_attention_reference(q, k, v, causal,
                                                         with_lse=True)
    delta = kernels.flash_bwd_delta_reference(o, do)
    args = (q, k, v, do, lse, delta, causal)
    pairs = [(o, want_o, 2e-5), (lse, want_lse, 2e-5),
             (kernels.flash_bwd_delta(o, do), delta, 1e-5)]
    pairs += [(g, w, 1e-5) for g, w in zip(
        kernels.flash_bwd_dkv(*args), kernels.flash_bwd_dkv_reference(*args))]
    pairs.append((kernels.flash_bwd_dq(*args),
                  kernels.flash_bwd_dq_reference(*args), 1e-5))
    torch.cuda.synchronize()
    for got, want, tol in pairs:
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


# ------------------------------------------- 3xTF32 numerics of the f32 body
#
# A torch model of what `flash_fwd_3xtf32_kernel` computes: every f32
# operand of both products split into TF32 hi + lo (cvt.rna.tf32.f32 on the
# f32 bits: add half of the 13 dropped bits, clear them) and each product
# taken as lo.hi + hi.lo + hi.hi, small terms first; the online softmax over
# the kernel's key tiles in base 2; P.V with the keys of every 8-key slice
# in the order the S fragment hands them to the A fragment (2t as k = t,
# 2t + 1 as k = t + 4). Held to the plain version and to the JAX forward at
# 1e-4, the tolerance the card's check uses for f32 attention; one TF32
# product a term is shown to miss it on the same inputs.

_LOG2E = 1.4426950408889634
#: the key order inside an 8-key slice as P.V's A fragment takes it
_PV_KEY_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


def _tf32_rna(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, terms):
    """a @ b with TF32 operands: 3 terms (3xTF32) or 1 (plain TF32)."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    if terms == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _f32_body_model(q, k, v, causal, terms=3):
    """o [B, S, H, D] and lse [B*H, S, 1] as the f32 body computes them."""
    b, s, h, d = q.shape
    bn = 32 if d > 64 else 64          # keys a tile, as F32Tiles<DMAX>
    scale = float(torch.tensor(1.0 / d ** 0.5, dtype=torch.float32))
    qs, kf, vf = (t.permute(0, 2, 1, 3) for t in (q * scale, k, v))
    pad = -s % bn                      # K and V zero-filled past S
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    acc = torch.zeros(b, h, s, d)
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros(b, h, s, 1)
    rows = torch.arange(s)[:, None]
    order = torch.tensor([8 * (n // 8) + _PV_KEY_ORDER[n % 8]
                          for n in range(bn)])
    for k0 in range(0, s, bn):
        kt, vt = kf[:, :, k0:k0 + bn], vf[:, :, k0:k0 + bn]
        sc = _mm_tf32(qs, kt.transpose(-1, -2), terms)
        keys = k0 + torch.arange(bn)[None, :]
        if causal:
            sc = sc.masked_fill(keys > rows, -1e30)
        sc = sc.masked_fill(keys >= s, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * _LOG2E)
        p = torch.exp2(sc * _LOG2E - m_new * _LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm_tf32(p[..., order], vt[:, :, order], terms)
        m = m_new
    lc = l.clamp_min(1e-30)
    o = (acc / lc).permute(0, 2, 1, 3)
    return o, (m + torch.log(lc)).reshape(b * h, s, 1)


def test_tf32_rounding_model_is_round_to_nearest_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10,
                      1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11), 0.0, -3.5])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 0.0, -3.5])
    assert torch.equal(_tf32_rna(x), want)
    # hi + lo keeps about 2^-22 of x, hi alone about 2^-11
    y = torch.from_numpy(np.random.RandomState(30).standard_normal(
        10_000).astype(np.float32))
    hi = _tf32_rna(y)
    lo = _tf32_rna(y - hi)
    assert ((hi - y).abs() / y.abs()).max() <= 2.0 ** -11
    assert ((hi + lo - y).abs() / y.abs()).max() <= 2.0 ** -21


F32_MODEL_CASES = [(d, s, causal) for d in (32, 100, 128) for s in (96, 200)
                   for causal in (False, True)]


@pytest.mark.parametrize("d,s,causal", F32_MODEL_CASES)
def test_3xtf32_model_holds_plain_version_and_jax_forward(d, s, causal):
    q, k, v = _qkv(31, 1, s, 2, d)
    got_o, got_lse = _f32_body_model(*_torch(q, k, v), causal)
    want_o, want_lse = kernels.flash_attention_reference(
        *_torch(q, k, v), causal, with_lse=True)
    torch.testing.assert_close(got_o, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_lse, want_lse, atol=1e-4, rtol=1e-4)
    # the JAX forward in interpret mode, at blocks that divide S (a ragged
    # block would take its blockwise fallback, which has no lse)
    block = 32 if s == 96 else 40
    jax_o, jax_lse = _flash_attention_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, block, block,
        True, with_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(jax_o), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(jax_lse),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d,s,causal", F32_MODEL_CASES)
def test_one_tf32_product_a_term_misses_the_f32_tolerance(d, s, causal):
    q, k, v = _qkv(31, 1, s, 2, d)
    got_o, _ = _f32_body_model(*_torch(q, k, v), causal, terms=1)
    want_o = kernels.flash_attention_reference(*_torch(q, k, v), causal)
    # o misses (the check holds o and lse both to 1e-4); lse, a log of a
    # sum of many rounded terms, may stay inside it
    assert not torch.allclose(got_o, want_o, atol=1e-4, rtol=1e-4)


F32_CUDA_CASES = [(d, s, causal, with_lse) for d in (30, 32, 64, 100, 128)
                  for s in (96, 200) for causal in (False, True)
                  for with_lse in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,s,causal,with_lse", F32_CUDA_CASES)
def test_cuda_f32_kernel_matches_plain_version_on_qkv_views(d, s, causal,
                                                            with_lse):
    # the 3xTF32 body on views of one fused projection at ragged S (both
    # end inside a 64-query block and a key tile); D = 100 is zero-filled
    # to 128, D = 30 takes the single-float copies (its rows are not
    # 16-byte aligned)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    rng = np.random.RandomState(32)
    b, h = 2, 4
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(
        np.float32)).cuda()
    q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    before = kernels.LAUNCHES["flash_attn_fwd"]
    got = kernels.flash_attention(q, k, v, causal, with_lse=with_lse)
    want = kernels.flash_attention_reference(q, k, v, causal,
                                             with_lse=with_lse)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attn_fwd"] == before + 1
    got, want = (got, want) if with_lse else ((got,), (want,))
    assert got[0].shape == q.shape and got[0].is_contiguous()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------ fused flash backward

def _jax_fwd_and_g(seed, b, s, h, d, causal, block):
    """q, k, v, o, lse and the output cotangent g as numpy arrays, o and
    lse from the JAX package's forward kernel (interpret mode)."""
    q, k, v = _qkv(seed, b, s, h, d)
    g = np.random.RandomState(seed + 100).standard_normal(
        (b, s, h, d)).astype(np.float32)
    o, lse = _flash_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal, block, block,
                                       True, with_lse=True)
    return q, k, v, np.array(o), np.array(lse), g


# -------------------------------------- 3xTF32 numerics of the f32 dK/dV body
#
# A torch model of what `flash_bwd_dkv_3xtf32_kernel` computes: the four
# products S^T = K.Q^T, dP^T = V.dO^T, dV += P^T.dO and dK += dS^T.Q, each
# with its f32 operands split into TF32 hi + lo and taken as lo.hi + hi.lo +
# hi.hi (small terms first); the query tiles in the body's order (16
# queries a tile at head dims above 64, else 32), queries 2t and 2t + 1 of
# every 8-query slice as k = t and t + 4 of dV's and dK's products (the
# order in which S^T's C fragment hands them to the A fragment); p in base
# 2, exp2(s * scale * log2(e) - lse * log2(e)), forced to 0 above the
# diagonal and on the query rows past S that a ragged last tile holds.
# The model sums in f32 with round-to-nearest; the tensor cores' own f32
# accumulation adds error that only the card shows (PERF.md). Held to the
# plain version and to the JAX fused backward at 1e-4, the tolerance the
# card's check uses for f32 attention; one TF32 product a term is shown to
# miss it on the same inputs.

def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _dkv_body_model(q, k, v, do, lse, delta, causal, terms=3):
    """(dk, dv) [B, S, H, D] as the f32 dK/dV body computes them."""
    b, s, h, d = q.shape
    bq = 16 if d > 64 else 32          # queries a tile, as DkvF32Tiles
    scale = _f32(1.0 / d ** 0.5)
    scale_l2 = scale * _f32(_LOG2E)
    pad = -s % bq                      # Q, dO, lse, delta zero-filled past S
    qf, kf, vf, dof = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))
    qf, dof = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (qf, dof))
    lse_l2 = torch.nn.functional.pad(lse.reshape(b, h, 1, s),
                                     (0, pad)) * _f32(_LOG2E)
    dlt = torch.nn.functional.pad(delta.reshape(b, h, 1, s), (0, pad))
    dk = torch.zeros(b, h, s, d)
    dv = torch.zeros(b, h, s, d)
    keys = torch.arange(s)[:, None]
    order = torch.tensor([8 * (n // 8) + _PV_KEY_ORDER[n % 8]
                          for n in range(bq)])
    for q0 in range(0, s + pad, bq):
        qt, dot = qf[:, :, q0:q0 + bq], dof[:, :, q0:q0 + bq]
        st = _mm_tf32(kf, qt.transpose(-1, -2), terms)     # [B, H, keys, bq]
        dpt = _mm_tf32(vf, dot.transpose(-1, -2), terms)
        p = torch.exp2(st * scale_l2 - lse_l2[..., q0:q0 + bq])
        queries = q0 + torch.arange(bq)[None, :]
        dead = (queries >= s) | (keys > queries) if causal else queries >= s
        p = p.masked_fill(dead, 0.0)
        ds = p * (dpt - dlt[..., q0:q0 + bq]) * scale
        dv = dv + _mm_tf32(p[..., order], dot[:, :, order], terms)
        dk = dk + _mm_tf32(ds[..., order], qt[:, :, order], terms)
    return tuple(t.permute(0, 2, 1, 3).contiguous() for t in (dk, dv))


def _dkv_model_case(d, s, causal):
    """Numpy q, k, v, o, lse, g (o and lse from the JAX forward in interpret
    mode, at blocks that divide S), and the torch inputs of the dK/dV body:
    q, k, v, g, lse and the plain delta."""
    q, k, v, o, lse, g = _jax_fwd_and_g(33, 1, s, 2, d, causal,
                                        32 if s == 96 else 40)
    tq, tk, tv, to, tlse, tg = _torch(q, k, v, o, lse, g)
    delta = kernels.flash_bwd_delta_reference(to, tg)
    return (q, k, v, o, lse, g), (tq, tk, tv, tg, tlse, delta)


@pytest.mark.parametrize("d,s,causal", F32_MODEL_CASES)
def test_3xtf32_dkv_model_holds_plain_version_and_jax_bwd(d, s, causal):
    arrays, args = _dkv_model_case(d, s, causal)
    got_dk, got_dv = _dkv_body_model(*args, causal)
    want_dk, want_dv = kernels.flash_bwd_dkv_reference(*args, causal)
    torch.testing.assert_close(got_dk, want_dk, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_dv, want_dv, atol=1e-4, rtol=1e-4)
    # the JAX fused backward in interpret mode, at blocks that divide S
    block = 32 if s == 96 else 40
    _, jax_dk, jax_dv = _flash_fused_bwd_impl(
        *(jnp.asarray(a) for a in arrays), causal, block, block, True, False)
    np.testing.assert_allclose(got_dk.numpy(), np.asarray(jax_dk), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got_dv.numpy(), np.asarray(jax_dv), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("d,s,causal", F32_MODEL_CASES)
def test_one_tf32_product_a_term_misses_the_f32_tolerance_in_dkv(d, s,
                                                                 causal):
    _, args = _dkv_model_case(d, s, causal)
    got = _dkv_body_model(*args, causal, terms=1)
    want = kernels.flash_bwd_dkv_reference(*args, causal)
    assert not all(torch.allclose(g, w, atol=1e-4, rtol=1e-4)
                   for g, w in zip(got, want))


F32_DKV_CUDA_CASES = [(d, s, causal) for d in (30, 64, 100, 128)
                      for s in (96, 200) for causal in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,s,causal", F32_DKV_CUDA_CASES)
def test_cuda_f32_dkv_kernel_matches_plain_version_on_qkv_views(d, s,
                                                                causal):
    # the 3xTF32 dK/dV body on views of one fused projection at ragged S
    # (both end inside a 64-key block and a query tile); D = 100 is
    # zero-filled to 128, D = 30 takes the single-float copies (its rows
    # are not 16-byte aligned)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    rng = np.random.RandomState(34)
    b, h = 2, 4
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(
        np.float32)).cuda()
    q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    g = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).cuda()
    o, lse = kernels.flash_attention_reference(q, k, v, causal,
                                               with_lse=True)
    delta = kernels.flash_bwd_delta_reference(o, g)
    before = kernels.LAUNCHES["flash_bwd_dkv"]
    got = kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    want = kernels.flash_bwd_dkv_reference(q, k, v, g, lse, delta, causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd_dkv"] == before + 1
    for gt, w in zip(got, want):
        assert gt.shape == q.shape and gt.is_contiguous()
        torch.testing.assert_close(gt, w, atol=1e-4, rtol=1e-4)


# ----------------------------------------- 3xTF32 numerics of the f32 dQ body
#
# A torch model of what `flash_bwd_dq_3xtf32_kernel` computes: S = Q.K^T and
# dP = dO.V^T with their f32 operands split into TF32 hi + lo, the key
# tiles in the body's order (16 keys a tile at head dims above 64, else
# 32), p in base 2, exp2(s * scale * log2(e) - lse * log2(e)), forced to 0
# above the diagonal and on the keys past S that a ragged last tile holds,
# and dQ += dS.K one 8-key k-step at a time straight into the f32 sum,
# lo.hi, then hi.lo, then hi.hi (the body keeps no zeroed accumulator a
# tile: PERF.md), keys 2t and 2t + 1 of each slice as k = t and t + 4 (the
# order in which S's C fragment hands them to the A fragment). Held to the
# plain version and to the JAX fused backward at 1e-4; one TF32 product a
# term is shown to miss it on the same inputs.

def _acc_tf32(acc, a, b, terms):
    """acc + a @ b with TF32 operands, each term added into acc in the
    order mma_3xtf32 issues it (3 terms), or one plain TF32 product."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    if terms == 1:
        return acc + a_hi @ b_hi
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    return ((acc + a_lo @ b_hi) + a_hi @ b_lo) + a_hi @ b_hi


def _dq_body_model(q, k, v, do, lse, delta, causal, terms=3):
    """dq [B, S, H, D] as the f32 dQ body computes it."""
    b, s, h, d = q.shape
    bk = 16 if d > 64 else 32          # keys a tile, as DqF32Tiles
    scale = _f32(1.0 / d ** 0.5)
    scale_l2 = scale * _f32(_LOG2E)
    pad = -s % bk                      # K and V zero-filled past S
    qf, kf, vf, dof = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))
    kf, vf = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (kf, vf))
    lse_l2 = lse.reshape(b, h, s, 1) * _f32(_LOG2E)
    dlt = delta.reshape(b, h, s, 1)
    dq = torch.zeros(b, h, s, d)
    rows = torch.arange(s)[:, None]
    order = torch.tensor(_PV_KEY_ORDER)
    for k0 in range(0, s + pad, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        st = _mm_tf32(qf, kt.transpose(-1, -2), terms)     # [B, H, S, bk]
        dpt = _mm_tf32(dof, vt.transpose(-1, -2), terms)
        p = torch.exp2(st * scale_l2 - lse_l2)
        keys = k0 + torch.arange(bk)[None, :]
        dead = (keys >= s) | (keys > rows) if causal else keys >= s
        p = p.masked_fill(dead, 0.0)
        ds = p * (dpt - dlt) * scale
        for kn in range(0, bk, 8):
            dq = _acc_tf32(dq, ds[..., kn:kn + 8][..., order],
                           kt[:, :, kn:kn + 8][:, :, order], terms)
    return dq.permute(0, 2, 1, 3).contiguous()


@pytest.mark.parametrize("d,s,causal", F32_MODEL_CASES)
def test_3xtf32_dq_model_holds_plain_version_and_jax_bwd(d, s, causal):
    arrays, args = _dkv_model_case(d, s, causal)
    got = _dq_body_model(*args, causal)
    want = kernels.flash_bwd_dq_reference(*args, causal)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    # the JAX fused backward in interpret mode, at blocks that divide S
    block = 32 if s == 96 else 40
    jax_dq, _, _ = _flash_fused_bwd_impl(
        *(jnp.asarray(a) for a in arrays), causal, block, block, True, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_dq), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("d,s,causal", F32_MODEL_CASES)
def test_one_tf32_product_a_term_misses_the_f32_tolerance_in_dq(d, s,
                                                                causal):
    _, args = _dkv_model_case(d, s, causal)
    got = _dq_body_model(*args, causal, terms=1)
    want = kernels.flash_bwd_dq_reference(*args, causal)
    assert not torch.allclose(got, want, atol=1e-4, rtol=1e-4)


F32_DQ_CUDA_CASES = [(d, s, causal) for d in (30, 64, 100, 128)
                     for s in (96, 200) for causal in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,s,causal", F32_DQ_CUDA_CASES)
def test_cuda_f32_dq_kernel_matches_plain_version_on_qkv_views(d, s,
                                                              causal):
    # the 3xTF32 dQ body on views of one fused projection at ragged S (both
    # end inside a 64-query block and a key tile); D = 100 is zero-filled to
    # 128, D = 30 takes the single-float copies (its rows are not 16-byte
    # aligned)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    rng = np.random.RandomState(35)
    b, h = 2, 4
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(
        np.float32)).cuda()
    q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    g = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).cuda()
    o, lse = kernels.flash_attention_reference(q, k, v, causal,
                                               with_lse=True)
    delta = kernels.flash_bwd_delta_reference(o, g)
    before = kernels.LAUNCHES["flash_bwd_dq"]
    got = kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal)
    want = kernels.flash_bwd_dq_reference(q, k, v, g, lse, delta, causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd_dq"] == before + 1
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# the last: S = 96 (under one 128-query block of the bf16 dQ kernel) at a
# head dim (100) that the bf16 kernels take through the padding route
BWD_SHAPES = [(2, 64, 2, 8), (1, 128, 2, 16), (1, 96, 2, 100)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_bwd_plain_versions_match_pallas_fused_bwd(shape, causal):
    # the three plain versions (what the wrappers run on CPU tensors) vs
    # `_flash_fused_bwd_impl` in interpret mode, f32, at the tolerance of
    # tests/test_mfu_paths.py
    q, k, v, o, lse, g = _jax_fwd_and_g(10, *shape, causal, 16)
    want_dq, want_dk, want_dv = _flash_fused_bwd_impl(
        *(jnp.asarray(a) for a in (q, k, v, o, lse, g)), causal, 16, 32,
        True, False)
    tq, tk, tv, to, tlse, tg = _torch(q, k, v, o, lse, g)
    delta = kernels.flash_bwd_delta(to, tg)
    b, s, h, _ = shape
    np.testing.assert_allclose(
        delta.numpy(), (o * g).sum(-1).transpose(0, 2, 1).reshape(b * h, s, 1),
        rtol=1e-5, atol=1e-5)
    dk, dv = kernels.flash_bwd_dkv(tq, tk, tv, tg, tlse, delta, causal)
    dq = kernels.flash_bwd_dq(tq, tk, tv, tg, tlse, delta, causal)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.shape == tuple(shape) and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("b", [1, 2])
def test_plain_delta_has_the_kernels_contiguous_layout(b):
    # the dK/dV and dQ wrappers take lse and delta only as contiguous
    # [B*H, S, 1]; for B=1 a reshape of the permuted sum is a strided view
    o, g = _torch(*_qkv(20, b, 33, 2, 8)[:2])
    delta = kernels.flash_bwd_delta(o, g)
    assert delta.shape == (b * 2, 33, 1) and delta.is_contiguous()


def test_bwd_plain_versions_cast_to_the_input_dtype():
    q, k, v, o, lse, g = _jax_fwd_and_g(11, 1, 32, 2, 8, True, 16)
    tq, tk, tv, to, tg = _torch(q, k, v, o, g, dtype=torch.bfloat16)
    tlse = torch.from_numpy(lse)
    delta = kernels.flash_bwd_delta(to, tg)
    assert delta.dtype == torch.float32 and delta.shape == (2, 32, 1)
    dk, dv = kernels.flash_bwd_dkv(tq, tk, tv, tg, tlse, delta, True)
    dq = kernels.flash_bwd_dq(tq, tk, tv, tg, tlse, delta, True)
    assert {t.dtype for t in (dq, dk, dv)} == {torch.bfloat16}


def _grads_of_port(q, k, v, g, causal, fused_bwd):
    leaves = [t.requires_grad_() for t in _torch(q, k, v)]
    o = kernels.flash_attention(*leaves, causal, fused_bwd=fused_bwd)
    return torch.autograd.grad(o, leaves, torch.from_numpy(g))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_function_grads_match_jax_fused_vjp(causal):
    q, k, v = _qkv(12, 2, 64, 2, 8)
    g = np.random.RandomState(13).standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        o = jax_flash_attention(q, k, v, causal, 16, 16, True, False, True,
                                16, 32)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    got = _grads_of_port(q, k, v, g, causal, fused_bwd=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("fused_bwd", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_function_ragged_grads_match_jax_blockwise(causal, fused_bwd):
    # S=70 divides no tile: the JAX package recomputes through
    # blockwise_attention there; the port's fused kernels mask the tail
    q, k, v = _qkv(14, 1, 70, 2, 8)
    g = np.random.RandomState(15).standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        o = jax_attention.blockwise_attention(q, k, v, block_size=16,
                                              causal=causal)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    got = _grads_of_port(q, k, v, g, causal, fused_bwd)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_flash_function_takes_views_and_a_strided_cotangent():
    # q, k, v as views of one fused projection, dO transposed in memory
    rng = np.random.RandomState(16)
    qkv = torch.from_numpy(rng.standard_normal((2, 12, 48)).astype(
        np.float32)).requires_grad_()
    q, k, v = (t.view(2, 12, 2, 8) for t in qkv.split(16, dim=-1))
    g = torch.from_numpy(rng.standard_normal((2, 2, 12, 8)).astype(
        np.float32)).transpose(1, 2)
    assert not g.is_contiguous()
    (got,) = torch.autograd.grad(
        kernels.flash_attention(q, k, v, True, fused_bwd=True), qkv, g)
    (want,) = torch.autograd.grad(
        kernels.flash_attention_reference(q, k, v, True), qkv, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_flash_function_counts_no_launch_on_cpu_and_without_grad():
    kernels.reset_launches()
    q, k, v = (t.requires_grad_() for t in _torch(*_qkv(17, 1, 16, 1, 8)))
    o = kernels.flash_attention(q, k, v, True, fused_bwd=True)
    o.sum().backward()
    with torch.no_grad():
        out = kernels.flash_attention(q, k, v, True, fused_bwd=True)
    assert out.grad_fn is None
    with pytest.raises(ValueError, match="with_lse"):
        kernels.flash_attention(q, k, v, True, with_lse=True)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernels_match_plain_versions(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    for causal, s in ((True, 200), (False, 256)):
        q, k, v, g = (t.cuda() for t in _torch(
            *_qkv(18, 2, s, 4, 64), _qkv(19, 2, s, 4, 64)[0], dtype=dt))
        o, lse = kernels.flash_attention(q, k, v, causal, with_lse=True)
        before = dict(kernels.LAUNCHES)
        delta = kernels.flash_bwd_delta(o, g)
        dk, dv = kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
        dq = kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal)
        want_delta = kernels.flash_bwd_delta_reference(o, g)
        want_dk, want_dv = kernels.flash_bwd_dkv_reference(
            q, k, v, g, lse, want_delta, causal)
        want_dq = kernels.flash_bwd_dq_reference(q, k, v, g, lse,
                                                 want_delta, causal)
        torch.cuda.synchronize()
        for name in ("flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dq"):
            assert kernels.LAUNCHES[name] == before[name] + 1
        torch.testing.assert_close(delta, want_delta, atol=1e-4, rtol=1e-4)
        for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
            err = (got.float() - want.float()).abs().max().item()
            tol = (1e-4 * (1 + want.abs().max().item())
                   if dt == torch.float32
                   else 2e-2 * want.float().abs().max().item())
            assert err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 128])
def test_cuda_tma_kernels_match_plain_versions_through_the_padding_route(d):
    # bf16 forward and dK/dV on qkv views: D = 128 reads them in place,
    # D = 100 goes through zero-padded copies of 128
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    rng = np.random.RandomState(25)
    b, s, h = 2, 200, 4
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    g = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    before = kernels.PAD_COPIES
    o, lse = kernels.flash_attention(q, k, v, True, with_lse=True)
    want_o, want_lse = kernels.flash_attention_reference(q, k, v, True,
                                                         with_lse=True)
    delta = kernels.flash_bwd_delta_reference(o, g)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, g, lse, delta, True)
    want_dk, want_dv = kernels.flash_bwd_dkv_reference(q, k, v, g, lse,
                                                       delta, True)
    torch.cuda.synchronize()
    # forward: q, k, v in and o out; dK/dV: q, k, v, dO in and dk, dv out
    assert kernels.PAD_COPIES - before == (0 if d == 128 else 3 + 1 + 4 + 2)
    for got, want in ((o, want_o), (dk, want_dk), (dv, want_dv)):
        assert got.shape == q.shape and got.is_contiguous()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * want.float().abs().max().item()
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [96, 200])
@pytest.mark.parametrize("d", [64, 100, 128])
def test_cuda_dq_kernel_matches_plain_version_on_qkv_views(d, s, causal):
    # the bf16 TMA + wgmma dQ body on views of one fused projection: S = 96
    # is less than one 128-query block, S = 200 ends in a ragged block and a
    # ragged key tile, D = 100 goes through zero-padded copies of 128
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    rng = np.random.RandomState(26)
    b, h = 2, 4
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    g = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    o, lse = kernels.flash_attention(q, k, v, causal, with_lse=True)
    delta = kernels.flash_bwd_delta_reference(o, g)
    before, copies = kernels.LAUNCHES["flash_bwd_dq"], kernels.PAD_COPIES
    got = kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal)
    want = kernels.flash_bwd_dq_reference(q, k, v, g, lse, delta, causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd_dq"] == before + 1
    # q, k, v, dO in and dq out where D is padded; none on qkv views of 128
    assert kernels.PAD_COPIES - copies == (5 if d == 100 else 0)
    assert got.shape == q.shape and got.is_contiguous()
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item()


# -------------------------------------------------------------- scatter-add
#
# The plain version (what `scatter_add_rows` runs on CPU tensors) against
# the JAX package's `scatter_add_rows` in Pallas interpret mode, as
# tests/test_pallas_kernels.py:71-90 runs it: exact on integer-valued f32
# (every partial sum is an exact integer, so the order of the adds cannot
# matter), allclose 1e-6 on random values (sums in another order).

from deeplearning4j_tpu.nd.pallas_kernels import (  # noqa: E402
    scatter_add_rows as jax_scatter_add_rows)


def _scatter_case(seed, r, d, n, integer, index_dtype=np.int32):
    rng = np.random.RandomState(seed)
    shape = (r, d) if d else (r,)
    ushape = (n, d) if d else (n,)
    if integer:
        table = rng.randint(-4, 5, shape).astype(np.float32)
        upd = rng.randint(-4, 5, ushape).astype(np.float32)
    else:
        table = rng.standard_normal(shape).astype(np.float32)
        upd = rng.standard_normal(ushape).astype(np.float32)
    # few distinct rows, so duplicates are many
    idx = rng.randint(0, min(r, 5), n).astype(index_dtype)
    return table, idx, upd


def _jax_scatter(table, idx, upd):
    t2, u2 = (a.reshape(a.shape[0], -1) for a in (table, upd))
    out = jax_scatter_add_rows(jnp.asarray(t2), jnp.asarray(idx),
                               jnp.asarray(u2), interpret=True)
    return np.asarray(out).reshape(table.shape)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", [
    "duplicates", "ragged", "d1_bias", "int64", "one_row"])
def test_scatter_plain_version_matches_pallas_kernel(case, integer):
    r, d, n, itype = {"duplicates": (10, 4, 16, np.int32),
                      "ragged": (7, 8, 13, np.int32),   # JAX pads N to 16
                      "d1_bias": (9, 0, 11, np.int32),  # a 1-D bias table
                      "int64": (6, 4, 8, np.int64),
                      "one_row": (3, 5, 1, np.int32)}[case]
    table, idx, upd = _scatter_case(21, r, d, n, integer, itype)
    want = _jax_scatter(table, idx, upd)
    tt = torch.from_numpy(table)
    got = kernels.scatter_add_rows(tt, torch.from_numpy(idx),
                                   torch.from_numpy(upd))
    assert got.shape == tt.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(tt.numpy(), table)   # a new tensor
    if integer:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_scatter_skips_rows_outside_the_table_like_jax_scatter():
    # jax.grad's scatter (`.at[idx].add`) drops indices >= R; the Pallas
    # kernel is undefined there. Negative indices, which `.at` would wrap,
    # are skipped too: no path produces them.
    table, _, upd = _scatter_case(22, 6, 4, 7, True)
    idx = np.array([0, 6, 2, 99, 2, 5, 6], np.int32)
    want = np.asarray(jnp.asarray(table).at[jnp.asarray(idx)].add(
        jnp.asarray(upd)))
    got = kernels.scatter_add_rows(torch.from_numpy(table),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(upd))
    np.testing.assert_array_equal(got.numpy(), want)
    neg = torch.tensor([-1, -6, 3], dtype=torch.int64)
    got = kernels.scatter_add_rows(torch.zeros(6, 2), neg, torch.ones(3, 2))
    want = np.zeros((6, 2), np.float32)
    want[3] = 1.0
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_in_place_and_empty_and_strided_updates():
    table = torch.zeros(5, 3)
    upd = torch.arange(24, dtype=torch.float32).reshape(4, 6)[:, ::2]
    assert not upd.is_contiguous()
    out = kernels.scatter_add_rows_(table, torch.tensor([4, 0, 4, 1]), upd)
    assert out is table
    want = np.zeros((5, 3), np.float32)
    for i, row in zip([4, 0, 4, 1], upd.numpy()):
        want[i] += row
    np.testing.assert_array_equal(table.numpy(), want)
    empty = kernels.scatter_add_rows(table, torch.zeros(0, dtype=torch.int32),
                                     torch.zeros(0, 3))
    np.testing.assert_array_equal(empty.numpy(), want)


def test_scatter_bf16_plain_version_and_refused_types():
    idx = torch.tensor([1, 1, 0], dtype=torch.int32)
    got = kernels.scatter_add_rows(torch.zeros(3, 4, dtype=torch.bfloat16),
                                   idx, torch.ones(3, 4, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy()[:, 0], [1.0, 2.0, 0.0])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels.scatter_add_rows(torch.zeros(3, 4, dtype=torch.float64), idx,
                                 torch.ones(3, 4, dtype=torch.float64))
    with pytest.raises(TypeError, match="even row width"):
        kernels.scatter_add_rows(torch.zeros(3, 3, dtype=torch.bfloat16),
                                 idx, torch.ones(3, 3, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="int32 or int64"):
        kernels.scatter_add_rows(torch.zeros(3, 4), idx.to(torch.int16),
                                 torch.ones(3, 4))
    with pytest.raises(TypeError, match="dtype"):
        kernels.scatter_add_rows(torch.zeros(3, 4), idx,
                                 torch.ones(3, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="want table"):
        kernels.scatter_add_rows(torch.zeros(3, 4), idx, torch.ones(2, 4))


@pytest.mark.parametrize("table_shape", [(11, 6), (11,)])
def test_gather_rows_grad_matches_autograd_of_plain_indexing(table_shape):
    rng = np.random.RandomState(23)
    table = rng.standard_normal(table_shape).astype(np.float32)
    idx = torch.from_numpy(rng.randint(0, 11, (7, 5)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal(
        (7, 5) + table_shape[1:]).astype(np.float32))
    grads = []
    kernels.reset_launches()
    for gather in (kernels.gather_rows, lambda t, i: t[i]):
        leaf = torch.from_numpy(table).requires_grad_()
        out = gather(leaf, idx)
        assert out.shape == (7, 5) + table_shape[1:]
        (grad,) = torch.autograd.grad(out, leaf, g)
        grads.append(grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-6, atol=1e-6)
    assert kernels.LAUNCHES["scatter_add_rows"] == 0   # CPU: plain version


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scatter_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(24)
    for r, d, n in ((1000, 128, 20000), (50, 1, 777), (7, 2, 5)):
        if dt == torch.bfloat16 and d % 2:
            continue
        table = torch.randn(r, d, generator=gen, device="cuda").to(dt)
        upd = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        idx = torch.randint(-2, r + 2, (n,), generator=gen, device="cuda")
        before = kernels.LAUNCHES["scatter_add_rows"]
        got = kernels.scatter_add_rows(table, idx, upd)
        want = kernels.scatter_add_rows_reference(table, idx, upd)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["scatter_add_rows"] == before + 1
        # atomics add in an order that changes from run to run
        tol = 1e-4 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol * (
            1 + want.float().abs().max().item()), rtol=tol)


# ------------------------------------------------- scatter-add at D = 1
#
# At D = 1 (the GloVe biases) the f32 kernel gives each thread one update,
# and each warp first sums the updates that share an index: groups from
# `__match_any_sync`, a tree of shuffles per group (`sum_peers` in
# csrc/scatter_add.cu), one atomic add per distinct index from the group's
# lowest lane. `_d1_body_model` replays that lane by lane in f32.

def _sum_peers(keys, x):
    """sum_peers over one warp: keys and f32 values of its 32 lanes; returns
    each lane's value after the tree (the group's lowest lane holds the
    group's sum)."""
    lanes = range(32)
    group = [sum(1 << m for m in lanes if keys[m] == keys[lane])
             for lane in lanes]
    pos = [bin(group[lane] & ((1 << lane) - 1)).count("1") for lane in lanes]
    peers = [group[lane] & ~((2 << lane) - 1) & 0xFFFFFFFF for lane in lanes]
    x = [np.float32(v) for v in x]
    while any(peers):
        nxt = [(p & -p).bit_length() - 1 for p in peers]   # -1: none left
        x = [x[lane] + x[nxt[lane]] if nxt[lane] >= 0 else x[lane]
             for lane in lanes]
        done = sum(1 << lane for lane in lanes if pos[lane] & 1)
        peers = [p & ~done for p in peers]
        pos = [p >> 1 for p in pos]
    return x


def _d1_body_model(table, idx, upd):
    """(table with the updates added as the D = 1 body adds them, the
    number of atomic adds it issues): warps of 32 updates in order, indices
    outside [0, R) skipped, one add per distinct index a warp."""
    out = table.astype(np.float32).copy()
    r, n = table.shape[0], idx.shape[0]
    atomics = 0
    for base in range(0, n, 32):
        keys = [int(idx[i]) if i < n and 0 <= idx[i] < r else -1
                for i in range(base, base + 32)]
        x = [upd[i] if keys[i - base] >= 0 else 0.0
             for i in range(base, base + 32)]
        sums = _sum_peers(keys, x)
        for lane, key in enumerate(keys):
            if key >= 0 and keys.index(key) == lane:
                out[key] = out[key] + sums[lane]
                atomics += 1
    return out, atomics


def _d1_case(seed, case, integer):
    """table [R], indices [N] and updates [N] for the D = 1 tests: zipf
    indices (the GloVe step's centers), indices with duplicates and
    outside the table on both sides at a ragged N, or one index."""
    rng = np.random.RandomState(seed)
    r, n = {"zipf": (50, 1000), "out_of_range": (9, 77),
            "one_index": (5, 64)}[case]
    if case == "zipf":
        idx = np.minimum(rng.zipf(1.3, n) - 1, r - 1)
    elif case == "out_of_range":
        idx = rng.randint(-3, r + 3, n)
    else:
        idx = np.full(n, 3)
    draw = ((lambda *shape: rng.randint(-4, 5, shape)) if integer
            else rng.standard_normal)
    return (draw(r).astype(np.float32), idx.astype(np.int32),
            draw(n).astype(np.float32))


def _any_order_bound(table, idx, upd):
    """2 n u S per row: the error bound of the row's sum taken in any
    order (n its adds plus one, S the sum of |table| and |updates|)."""
    r = table.shape[0]
    ok = (idx >= 0) & (idx < r)
    n = np.bincount(idx[ok], minlength=r) + 1
    s = np.abs(table).astype(np.float64)
    np.add.at(s, idx[ok], np.abs(upd[ok]))
    return 2 * n * 2.0 ** -24 * s


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", ["zipf", "out_of_range", "one_index"])
def test_d1_warp_aggregation_model_holds_the_plain_version(case, integer):
    table, idx, upd = _d1_case(36, case, integer)
    got, atomics = _d1_body_model(table, idx, upd)
    want = kernels.scatter_add_rows_reference(
        torch.from_numpy(table), torch.from_numpy(idx),
        torch.from_numpy(upd)).numpy()
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= _any_order_bound(table, idx, upd)).all()
    # one atomic per distinct in-range index of each warp
    distinct = sum(len({i for i in idx[b:b + 32] if 0 <= i < len(table)})
                   for b in range(0, len(idx), 32))
    assert atomics == distinct
    if case != "out_of_range":
        assert atomics < len(idx) // 2


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_scatter_d1_skips_out_of_range_like_the_jax_kernel_in_range(bias,
                                                                    integer):
    # a bias [R] (or an [R, 1] table) with duplicates and indices outside
    # [0, R) on both sides: the port skips them, which is the JAX kernel
    # (undefined outside the table) given only the in-range updates
    table, idx, upd = _d1_case(37, "out_of_range", integer)
    if not bias:
        table, upd = table[:, None], upd[:, None]
    keep = (idx >= 0) & (idx < table.shape[0])
    want = _jax_scatter(table, idx[keep], upd[keep])
    got = kernels.scatter_add_rows(torch.from_numpy(table),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(upd))
    assert got.shape == table.shape
    if integer:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("index_dtype", ["int32", "int64"])
@pytest.mark.parametrize("bias", [True, False])
def test_cuda_scatter_d1_body_matches_plain_version(bias, index_dtype):
    # the one-thread-per-update body: exact on integers, within the
    # any-order bound on random values, out-of-range indices skipped
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    for case in ("zipf", "out_of_range", "one_index"):
        for integer in (True, False):
            table, idx, upd = _d1_case(38, case, integer)
            tt, tu = torch.from_numpy(table), torch.from_numpy(upd)
            if not bias:
                tt, tu = tt[:, None], tu[:, None]
            ti = torch.from_numpy(idx).to(getattr(torch, index_dtype))
            tt, ti, tu = tt.cuda(), ti.cuda(), tu.cuda()
            before = kernels.LAUNCHES["scatter_add_rows"]
            got = kernels.scatter_add_rows(tt, ti, tu)
            want = kernels.scatter_add_rows_reference(tt, ti, tu)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["scatter_add_rows"] == before + 1
            got, want = got.cpu().numpy().reshape(-1), \
                want.cpu().numpy().reshape(-1)
            if integer:
                np.testing.assert_array_equal(got, want)
            else:
                assert (np.abs(got - want)
                        <= _any_order_bound(table, idx, upd)).all()
