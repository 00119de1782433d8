"""The port's scatter-add: its plain version on the CPU, a model of the f32
D > 1 kernel body's order of adds, and that body on the card.

The plain version (what `scatter_add_rows` runs on CPU tensors) adds each
row's updates one at a time in the order of n, as the JAX package's
kernel does. So it is bitwise the same on every run, whatever the thread
count, and equal to JAX `scatter_add_rows` in Pallas interpret mode (as
tests/test_pallas_kernels.py runs it): bitwise on integer-valued data
(every partial sum is an exact integer), within 1e-6 on random data.

`_sorted_body_model` replays, in f32, the order in which
`scatter_add_f32_sorted_kernel` (csrc/scatter_add.cu) adds: chunks of
256, 512 or 1,024 updates; in each, the in-range indices sorted stably and
cut into 8 equal ranges, one a warp; each run of equal indices in a range
summed from zero in the order of n, then added to its table row with one
atomic (in any order on the card). It is held to JAX within the any-order
bound 2 n u S and bitwise on integers. The kernel itself runs only on a
GPU: those tests carry the `cuda` marker and skip here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nd.pallas_kernels import (  # noqa: E402
    scatter_add_rows as jax_scatter_add_rows)
from deeplearning4j_tpu_torch.nd import kernels  # noqa: E402

WARPS = 8  # warps of a block of the sorted body, one range of ranks each


def _jax_scatter(table, idx, upd):
    """JAX `scatter_add_rows` in interpret mode on float32 numpy arrays."""
    out = jax_scatter_add_rows(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(upd), interpret=True)
    return np.asarray(out)


def _draw(rng, shape, integer):
    if integer:
        return rng.randint(-4, 5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _index_case(rng, case, r, n):
    """Indices [N] of a case: zipf (the head takes most updates, as in the
    word2vec tables), every update in one row, uniform, or uniform with
    indices outside [0, R) on both sides."""
    if case == "zipf":
        return np.minimum(rng.zipf(1.3, n) - 1, r - 1).astype(np.int32)
    if case == "hot_row":
        return np.full(n, r // 2, np.int32)
    if case == "uniform":
        return rng.randint(0, r, n).astype(np.int32)
    return rng.randint(-3, r + 3, n).astype(np.int32)


def _clipped_zipf_pmf(a, r):
    """The law of min(zipf(a) - 1, r - 1) (`_index_case`'s zipf indices):
    p_k = (k + 1)^-a / zeta(a) below r - 1, the tail in the last row;
    zeta(a) by Euler-Maclaurin after 10^6 terms."""
    j = np.arange(1, 10 ** 6 + 1, dtype=np.float64)
    big = float(j[-1])
    zeta = (j ** -a).sum() + big ** (1 - a) / (a - 1) - big ** -a / 2
    p = np.arange(1, r, dtype=np.float64) ** -a / zeta
    return np.append(p, 1.0 - p.sum())


def _expected_distinct(p, m):
    """The expected number of distinct values among m draws from p."""
    return float((1.0 - (1.0 - p) ** m).sum())


def _any_order_bound(table, idx, upd):
    """2 n u S element by element: the error bound of each row's sum taken
    in any order (n its adds plus one, S the sum of |table| and |updates|,
    u the f32 unit roundoff)."""
    r = table.shape[0]
    ok = (idx >= 0) & (idx < r)
    n = np.bincount(idx[ok], minlength=r) + 1
    s = np.abs(table).astype(np.float64)
    np.add.at(s, idx[ok], np.abs(upd[ok]))
    return 2 * n[:, None] * 2.0 ** -24 * s


# ------------------------------------------------------ the plain version

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scatter_is_bitwise_repeatable_on_four_threads(dtype):
    # 40,000 x 8 updates into 50 rows: 320,000 elements, where index_put_
    # with accumulate adds float32 with parallel atomics
    rng = np.random.RandomState(40)
    dt = getattr(torch, dtype)
    table = torch.from_numpy(_draw(rng, (50, 8), False)).to(dt)
    upd = torch.from_numpy(_draw(rng, (40_000, 8), False)).to(dt)
    idx = torch.from_numpy(rng.randint(0, 50, 40_000).astype(np.int32))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        first = kernels.scatter_add_rows_reference(table, idx, upd)
        for _ in range(19):
            assert torch.equal(
                kernels.scatter_add_rows_reference(table, idx, upd), first)
    finally:
        torch.set_num_threads(threads)
    assert first.dtype == dt


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scatter_equals_the_jax_kernel_at_40000_updates(dtype,
                                                              integer):
    # the same sums in the same order as the JAX kernel's serial grid, in
    # the table's dtype (bfloat16 rounds after every add in both)
    rng = np.random.RandomState(41)
    table, upd = _draw(rng, (50, 8), integer), _draw(rng, (40_000, 8),
                                                     integer)
    idx = rng.randint(0, 50, 40_000).astype(np.int32)
    dt = getattr(torch, dtype)
    tt, tu = torch.from_numpy(table).to(dt), torch.from_numpy(upd).to(dt)
    if dtype == "bfloat16":
        # the JAX side gets the same bfloat16 values
        table, upd = tt.float().numpy(), tu.float().numpy()
        want = np.asarray(jax_scatter_add_rows(
            jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(idx),
            jnp.asarray(upd).astype(jnp.bfloat16),
            interpret=True).astype(jnp.float32))
    else:
        want = _jax_scatter(table, idx, upd)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got = kernels.scatter_add_rows_reference(
            tt, torch.from_numpy(idx), tu).float().numpy()
    finally:
        torch.set_num_threads(threads)
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_plain_scatter_keeps_skipping_rows_outside_the_table():
    # out-of-range indices still go to the spare row that is dropped, on
    # the serial float32 path and the bfloat16 one
    idx = torch.tensor([0, -1, 5, 2, 9, 2], dtype=torch.int64)
    for dt in (torch.float32, torch.bfloat16):
        got = kernels.scatter_add_rows_reference(
            torch.zeros(5, 2, dtype=dt), idx, torch.ones(6, 2, dtype=dt))
        np.testing.assert_array_equal(got.float().numpy()[:, 0],
                                      [1.0, 0.0, 2.0, 0.0, 0.0])


# --------------------------------------- the f32 D > 1 body's order of adds

def _sorted_body_model(table, idx, upd, chunk):
    """(the table with the updates added as the sorted-chunk body adds them,
    the atomic adds it issues a column group) in f32: chunks of `chunk`
    updates; a chunk's in-range indices sorted stably (out-of-range ones
    take the key R and sort last), its ranks cut into WARPS equal ranges;
    in a range each run of equal indices summed from zero in the order of
    n (a sequential cumsum), then added to its row."""
    out = table.astype(np.float32).copy()
    r, n = table.shape[0], idx.shape[0]
    atomics = 0
    per = chunk // WARPS
    for base in range(0, n, chunk):
        ids = idx[base:base + chunk].astype(np.int64)
        keys = np.where((ids >= 0) & (ids < r), ids, r)
        order = np.argsort(keys, kind="stable")
        n_valid = int((keys < r).sum())
        for warp in range(WARPS):
            lo, hi = warp * per, min((warp + 1) * per, n_valid)
            rk = lo
            while rk < hi:
                key = keys[order[rk]]
                end = rk
                while end < hi and keys[order[end]] == key:
                    end += 1
                rows = upd[base + order[rk:end]]
                out[key] = out[key] + np.cumsum(rows, axis=0,
                                                dtype=np.float32)[-1]
                atomics += 1
                rk = end
    return out, atomics


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", ["zipf", "hot_row", "uniform",
                                  "out_of_range", "ragged_d"])
@pytest.mark.parametrize("chunk", [256, 512, 1024])
def test_sorted_body_model_holds_the_jax_kernel(chunk, case, integer):
    rng = np.random.RandomState(42)
    r, d, n = 300, 6 if case == "ragged_d" else 8, 5_000
    idx = _index_case(rng, "out_of_range" if case == "ragged_d" else case,
                      r, n)
    table, upd = _draw(rng, (r, d), integer), _draw(rng, (n, d), integer)
    got, atomics = _sorted_body_model(table, idx, upd, chunk)
    keep = (idx >= 0) & (idx < r)
    # the JAX kernel is undefined outside the table: it gets the in-range
    # updates, which is what skipping the others computes
    want = _jax_scatter(table, idx[keep], upd[keep])
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want)
                <= _any_order_bound(table, idx, upd)).all()
    # one atomic a run of equal indices in each warp's range: never more
    # than the updates, and far fewer where the indices repeat
    assert atomics <= keep.sum()
    sizes = [min(chunk, n - base) for base in range(0, n, chunk)]
    if case == "hot_row":
        # one run in each warp range that holds an update
        per = chunk // WARPS
        assert atomics == sum(-(-m // per) for m in sizes)
    if case == "zipf":
        # a chunk's atomics are its distinct indices plus the runs its
        # WARPS - 1 inner range edges split; E and sd of the distinct
        # count of m draws from p: sum_k 1 - (1 - p_k)^m, sd <= sqrt(E)
        expect = sum(_expected_distinct(_clipped_zipf_pmf(1.3, r), m)
                     for m in sizes)
        slack = 4 * np.sqrt(expect)
        assert expect - slack <= atomics
        assert atomics <= expect + (WARPS - 1) * len(sizes) + slack


def test_sorted_body_model_issues_one_atomic_a_run_of_a_warps_range():
    # every update of a chunk into one row: the 8 warps' ranges each hold
    # one run, so a chunk costs 8 atomics a column group, not `chunk`
    rng = np.random.RandomState(43)
    idx = np.full(2048, 7, np.int32)
    table, upd = _draw(rng, (9, 4), True), _draw(rng, (2048, 4), True)
    for chunk in (256, 512, 1024):
        got, atomics = _sorted_body_model(table, idx, upd, chunk)
        assert atomics == WARPS * 2048 // chunk
        np.testing.assert_array_equal(got, _jax_scatter(table, idx, upd))


# ------------------------------------------------------------------ card

#: (case, R, D, N); on an H100 (132 SMs) the launch rule gives N = 32,768
#: chunks of 256 updates, 196,608 chunks of 512 and 622,592 chunks of 1,024
SCATTER_CUDA_CASES = [("hot_row", 9_999, 128, 622_592),
                      ("uniform", 9_999, 128, 622_592),
                      ("ragged_d", 1_000, 30, 50_000),
                      ("syn1_shape", 9_999, 128, 622_592),
                      ("syn1neg_shape", 10_000, 128, 196_608),
                      ("syn0_shape", 10_000, 128, 32_768)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,r,d,n", SCATTER_CUDA_CASES)
def test_cuda_sorted_scatter_body_matches_plain_version(case, r, d, n):
    # exact on integers, within the any-order bound on random values; the
    # "*_shape" cases draw zipf indices at word2vec's table shapes (the
    # Huffman root's share of syn1's rows is in the same range)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    rng = np.random.RandomState(44)
    idx = _index_case(rng, "zipf" if case.endswith("_shape") else
                      {"ragged_d": "out_of_range"}.get(case, case), r, n)
    ti = torch.from_numpy(idx).cuda()
    for integer in (True, False):
        table = torch.from_numpy(_draw(rng, (r, d), integer)).cuda()
        upd = torch.from_numpy(_draw(rng, (n, d), integer)).cuda()
        want = kernels.scatter_add_rows_reference(table, ti, upd)
        before = kernels.LAUNCHES["scatter_add_rows"]
        got = kernels.scatter_add_rows(table, ti, upd)
        assert kernels.LAUNCHES["scatter_add_rows"] == before + 1
        torch.cuda.synchronize()
        keep = (ti >= 0) & (ti < r)
        count = torch.bincount(ti[keep].long(), minlength=r).float() + 1
        s = kernels.scatter_add_rows_reference(table.abs(), ti, upd.abs())
        bound = 2 * count[:, None] * 2.0 ** -24 * s
        if integer:
            assert torch.equal(got, want)
        else:
            assert bool(((got - want).abs() <= bound).all())
