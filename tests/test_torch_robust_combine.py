"""The port's robust_combine against the reference.

On the CPU the op runs its plain network version, held here against the
JAX package's sorting network, its ``jnp.sort`` oracle and its Pallas
kernel in interpret mode, on the same numpy inputs. The CUDA kernel
itself runs only on a card: ``chip_smoke.py`` holds it against the plain
version there.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.robust_combine.kernel import (  # noqa: E402
    oddeven_merge_pairs as j_pairs)
from repro.kernels.robust_combine.ops import (  # noqa: E402
    robust_combine as j_robust_combine,
    row_select_weights as j_row_select_weights)
from repro.kernels.robust_combine.ref import (  # noqa: E402
    robust_combine_ref as j_ref)
from repro_torch.kernels.robust_combine import (  # noqa: E402
    MAX_CLIENTS, combine_rows, merge_pairs_by_loops, oddeven_merge_pairs,
    robust_combine, robust_combine_network_ref, robust_combine_ref,
    row_select_weights, sort_rows)

# the sorted values are exact; only the order of the final dot differs
TOL = dict(rtol=1e-6, atol=1e-6)
MODES = [("trimmed_mean", 0.0), ("trimmed_mean", 0.2),
         ("trimmed_mean", 0.49), ("median", 0.0)]


def _x(C, M, seed, ties=False):
    x = np.random.default_rng(seed).standard_normal((C, M)).astype(
        np.float32)
    return np.round(x) if ties else x


def _assert_matches_reference(x, mask, mode, trim):
    got = robust_combine(torch.from_numpy(x), torch.from_numpy(mask),
                         mode=mode, trim_fraction=trim).numpy()
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    w_row = j_row_select_weights(mj, mode=mode, trim_fraction=trim)
    want = {"sort": j_ref(xj, mj, w_row)}
    for impl, kw in (("network", {}),
                     ("pallas", {"block_m": 512, "interpret": True})):
        want[impl] = j_robust_combine(xj, mask=mj, mode=mode,
                                      trim_fraction=trim, impl=impl, **kw)
    for impl, w in want.items():
        np.testing.assert_allclose(
            got, np.asarray(w), **TOL,
            err_msg=f"{impl} C={x.shape[0]} mode={mode} trim={trim}")
    return got


def test_schedule_is_the_reference_schedule():
    for c in range(1, 65):
        assert oddeven_merge_pairs(c) == j_pairs(c), c
    assert [len(oddeven_merge_pairs(c)) for c in (16, 20, 32, 64)] == [
        63, 103, 191, 543]


def test_kernel_loops_are_the_schedule():
    """Above 64 clients the CUDA kernel generates its pairs at run time,
    dividing by 2p as a shift; its loops give the reference's schedule."""
    for c in range(1, 301):
        assert merge_pairs_by_loops(c) == oddeven_merge_pairs(c), c


def test_max_clients_fills_a_block_of_32_columns():
    """MAX_CLIENTS rows of 32 f32 columns fill the 227 KB (232,448 bytes)
    of shared memory a Hopper block may have; one more row does not."""
    assert MAX_CLIENTS >= 1024
    assert MAX_CLIENTS * 32 * 4 <= 232_448 < (MAX_CLIENTS + 1) * 32 * 4


def test_network_sorts_every_01_input():
    """0-1 principle: a comparator network sorts every input iff it sorts
    every 0/1 input; every 0/1 column of c <= 10 rows at once."""
    for c in range(1, 11):
        cols = torch.tensor(list(itertools.product((0.0, 1.0), repeat=c))).T
        rows = torch.stack(sort_rows(list(cols)))
        assert torch.equal(rows, torch.sort(cols, dim=0).values), c


@pytest.mark.parametrize("C", [1, 2, 5, 8, 20])
@pytest.mark.parametrize("mode,trim", [("trimmed_mean", 0.0),
                                       ("trimmed_mean", 0.2),
                                       ("trimmed_mean", 0.49),
                                       ("median", 0.0)])
def test_row_select_weights_are_the_reference_weights(C, mode, trim):
    rng = np.random.default_rng(C)
    for k in range(C + 1):
        mask = np.zeros((C,), np.float32)
        mask[rng.permutation(C)[:k]] = 1.0
        got = row_select_weights(torch.from_numpy(mask), mode=mode,
                                 trim_fraction=trim).numpy()
        want = np.asarray(j_row_select_weights(
            jnp.asarray(mask), mode=mode, trim_fraction=trim))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")


@pytest.mark.parametrize("C", [2, 3, 4, 7, 8, 16, 17, 20, 65, 100, 130])
@pytest.mark.parametrize("mode,trim", MODES)
def test_plain_matches_reference(C, mode, trim):
    x = _x(C, 1000, seed=C)
    _assert_matches_reference(x, np.ones((C,), np.float32), mode, trim)


@pytest.mark.parametrize("C", [4, 5, 16, 20])
def test_plain_matches_reference_with_ties(C):
    x = _x(C, 257, seed=C + 50, ties=True)
    for mode, trim in (("trimmed_mean", 0.25), ("median", 0.0)):
        _assert_matches_reference(x, np.ones((C,), np.float32), mode, trim)


@pytest.mark.parametrize("C", [3, 6, 16, 20])
def test_plain_matches_reference_masked(C):
    """Gated clients (mask 0) are left out; an all-zero mask gives exact
    zeros, never the sentinel."""
    x = _x(C, 384, seed=C + 100)
    mask = (np.random.default_rng(C).uniform(size=C) > 0.4).astype(
        np.float32)
    mask[0] = 1.0
    for mode, trim in MODES:
        _assert_matches_reference(x, mask, mode, trim)
        zero = _assert_matches_reference(x, np.zeros((C,), np.float32),
                                         mode, trim)
        np.testing.assert_array_equal(zero, np.zeros(384, np.float32))


@pytest.mark.parametrize("M", [257, 1000, 4099])
def test_plain_matches_reference_at_ragged_widths(M):
    _assert_matches_reference(_x(8, M, seed=M), np.ones((8,), np.float32),
                              "trimmed_mean", 0.25)


def test_network_matches_sort_oracle_within_the_port():
    x = torch.from_numpy(_x(17, 500, seed=7))
    mask = torch.from_numpy((np.arange(17) % 3 > 0).astype(np.float32))
    for mode, trim in MODES:
        w_row = row_select_weights(mask, mode=mode, trim_fraction=trim)
        torch.testing.assert_close(robust_combine_network_ref(x, mask, w_row),
                                   robust_combine_ref(x, mask, w_row), **TOL)


def test_network_propagates_nan_as_the_reference_does():
    _assert_nan_propagates(5)


@pytest.mark.parametrize("C", [65, 100, 130])
def test_network_propagates_nan_above_64_clients(C):
    """The clients the CUDA route stages in shared memory: NaN and inf
    land where the reference puts them."""
    _assert_nan_propagates(C)


def _assert_nan_propagates(C):
    x = _x(C, 4, seed=3)
    x[2, 1] = np.nan
    x[C - 1, 3] = np.inf
    mask = np.ones((C,), np.float32)
    got = robust_combine(torch.from_numpy(x), torch.from_numpy(mask),
                         mode="median").numpy()
    want = np.asarray(j_robust_combine(jnp.asarray(x), mask=jnp.asarray(mask),
                                       mode="median", impl="network"))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    # column 3: the inf sorts last, where w_row is 0, and 0 * inf is NaN
    assert np.isnan(got[[1, 3]]).all() and np.isfinite(got[[0, 2]]).all()


def test_cpu_input_runs_plain_version_without_counting():
    x = torch.from_numpy(_x(70, 10, seed=1))      # the staged kernel's C
    before = robust_combine.launches
    out = robust_combine(x, mode="median")
    assert out.shape == (10,) and robust_combine.launches == before
    torch.testing.assert_close(out, x.median(dim=0).values * 0.5
                               + torch.sort(x, dim=0).values[35] * 0.5)


@pytest.mark.parametrize("x_shape,mask_shape,dtype,err", [
    ((3, 8), (4,), torch.float32, ValueError),
    ((24,), (24,), torch.float32, ValueError),
    ((3, 8), (3,), torch.float64, TypeError),
    ((3, 8), (3,), torch.bfloat16, TypeError),
])
def test_wrapper_refuses_bad_inputs(x_shape, mask_shape, dtype, err):
    with pytest.raises(err):
        combine_rows(torch.zeros(x_shape, dtype=dtype),
                     torch.ones(mask_shape), torch.ones(mask_shape))


def test_bad_mode_and_trim_are_refused():
    mask = torch.ones((4,))
    with pytest.raises(ValueError, match="mode"):
        row_select_weights(mask, mode="nope")
    with pytest.raises(ValueError, match="trim_fraction"):
        row_select_weights(mask, trim_fraction=1.0)


def test_non_cpu_non_cuda_tensor_raises_instead_of_falling_back():
    x = torch.empty((3, 8), device="meta")
    m = torch.empty((3,), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        combine_rows(x, m, m)
