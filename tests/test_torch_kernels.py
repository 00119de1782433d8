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
