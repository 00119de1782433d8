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


BWD_SHAPES = [(2, 64, 2, 8), (1, 128, 2, 16)]


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
