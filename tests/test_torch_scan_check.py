"""T1's port on the CPU (its plain version) against the Pallas kernel.

test_pallas.py::test_wide_scans_match_flat runs the Pallas kernels' shared
scan helpers inside a pallas_call. The same seed-17 input goes through
that kernel (interpret mode) and through wah_tpu_torch's rows_scan on CPU
tensors; the search output is held against numpy. Tolerance zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from wah_tpu.ops.pallas import common
from wah_tpu_torch.ops.cuda import scan_check


def _pallas_scans(x: np.ndarray, neutral: int = -1):
    def ker(x_ref, s_ref, m_ref):
        s_ref[:] = common.cumsum_lanes_wide(x_ref[:])
        m_ref[:] = common.cummax_lanes_wide(x_ref[:], jnp.int32(neutral))

    out_shape = [jax.ShapeDtypeStruct(x.shape, jnp.int32)] * 2
    s, m = pl.pallas_call(ker, out_shape=out_shape, interpret=True)(x)
    return np.asarray(s), np.asarray(m)


def _keys(csum: np.ndarray, q: int, lo: int, hi: int, seed: int) -> np.ndarray:
    """Keys from cumsum[lo] (the contract's floor) to past the last sum, a
    third of them the sums themselves, which tie exactly."""
    rng = np.random.default_rng(seed)
    rows = csum.shape[0]
    if q == 0:
        return np.zeros((rows, 0), np.int32)
    keys = rng.integers(csum[:, lo : lo + 1], csum[:, hi - 1 : hi] + 50, size=(rows, q))
    picks = np.take_along_axis(csum[:, lo:hi], rng.integers(0, hi - lo, (rows, q)), 1)
    keys[:, ::3] = picks[:, ::3]
    return keys.astype(np.int32)


def test_rows_scan_matches_pallas_kernel():
    x = np.random.default_rng(17).integers(0, 100, size=(4, 2048), dtype=np.int32)
    js, jm = _pallas_scans(x)
    keys = _keys(js, 64, 0, 2048, seed=1)
    before = scan_check.rows_scan.launches
    csum, cmax, idx = scan_check.rows_scan(torch.from_numpy(x), torch.from_numpy(keys))
    assert scan_check.rows_scan.launches == before  # a CPU tensor launches nothing
    np.testing.assert_array_equal(csum.numpy(), js)
    np.testing.assert_array_equal(cmax.numpy(), jm)
    assert idx.dtype == torch.int32
    for r in range(4):
        want = np.searchsorted(js[r], keys[r], side="right") - 1
        np.testing.assert_array_equal(idx[r].numpy(), want)


@pytest.mark.parametrize("low,high,lo,hi", [
    (0, 2, 0, 2048),    # long ties: the largest index wins
    (0, 1, 0, 2048),    # every key ties with every entry
    (0, 100, 5, 1902),  # hi - lo not a multiple of 32
    (0, 100, 77, 78),   # a span of one
], ids=["ties", "all_zero", "odd_span", "span_of_one"])
def test_rows_scan_search_ties_and_spans(low, high, lo, hi):
    x = np.random.default_rng(5).integers(low, high, size=(6, 2048), dtype=np.int32)
    csum = np.cumsum(x, axis=1, dtype=np.int32)
    keys = _keys(csum, 40, lo, hi, seed=2)
    _, _, idx = scan_check.rows_scan(torch.from_numpy(x), torch.from_numpy(keys), lo, hi)
    for r in range(x.shape[0]):
        # the largest i in [lo, hi) with csum[i] <= key
        want = [max(i for i in range(lo, hi) if csum[r, i] <= k) for k in keys[r]]
        np.testing.assert_array_equal(idx[r].numpy(), want)


def test_rows_scan_negative_values_and_arguments():
    x = np.random.default_rng(3).integers(-50, -10, size=(3, 2048), dtype=np.int32)
    keys = torch.zeros((3, 0), dtype=torch.int32)
    csum, cmax, idx = scan_check.rows_scan(torch.from_numpy(x), keys)
    np.testing.assert_array_equal(csum.numpy(), np.cumsum(x, axis=1))
    np.testing.assert_array_equal(cmax.numpy(), np.maximum.accumulate(x, axis=1))
    assert idx.shape == (3, 0)
    with pytest.raises(ValueError):
        scan_check.rows_scan(torch.zeros((2, 1024), dtype=torch.int32), keys[:2])
    with pytest.raises(ValueError):
        scan_check.rows_scan(torch.from_numpy(x), keys, 10, 10)
    with pytest.raises(TypeError):
        scan_check.rows_scan(torch.from_numpy(x).long(), keys)


INT_MIN = np.iinfo(np.int32).min


@pytest.mark.parametrize("span", [(0, 2048), (5, 1902)], ids=["whole_row", "span_inside"])
@pytest.mark.parametrize("q", [0, 1, 64, 300])
@pytest.mark.parametrize("rows", [1, 3, 1057])
def test_rows_scan_row_and_key_counts_match_pallas_and_numpy(rows, q, span):
    """One row, a few, and one more than a multiple of any grid; no key, one,
    the kernel's 64 and more than the 256 a CTA holds at once."""
    lo, hi = span
    x = np.random.default_rng(rows).integers(0, 100, size=(rows, 2048), dtype=np.int32)
    js, jm = _pallas_scans(x)
    keys = _keys(js, q, lo, hi, seed=q)
    csum, cmax, idx = scan_check.rows_scan(torch.from_numpy(x), torch.from_numpy(keys), lo, hi)
    np.testing.assert_array_equal(csum.numpy(), js)
    np.testing.assert_array_equal(cmax.numpy(), jm)
    np.testing.assert_array_equal(csum.numpy(), np.cumsum(x, axis=1, dtype=np.int32))
    assert idx.shape == (rows, q) and idx.dtype == torch.int32
    for r in range(min(rows, 5)):
        want = np.searchsorted(js[r, lo:hi], keys[r], side="right") - 1 + lo
        np.testing.assert_array_equal(idx[r].numpy(), want)


@pytest.mark.parametrize("name", ["mixed_sign_outside_the_span", "int_min_rows",
                                  "rows_that_start_at_int_min"])
def test_rows_scan_signs_match_pallas_and_numpy(name):
    """Negative values: the sum wraps in int32, the running maximum starts
    from the row's first element, the search sees only its span."""
    rng = np.random.default_rng(29)
    lo, hi, q = 0, 2048, 0
    if name == "mixed_sign_outside_the_span":
        x = rng.integers(-1000, 1000, size=(37, 2048), dtype=np.int32)
        lo, hi, q = 700, 1500, 64
        x[:, lo:hi] = np.abs(x[:, lo:hi])
    else:
        x = np.full((5, 2048), INT_MIN, np.int32)
        if name == "rows_that_start_at_int_min":
            x[:, 1:] = rng.integers(-5, 5, size=(5, 2047))
    js, jm = _pallas_scans(x, neutral=INT_MIN)
    with np.errstate(over="ignore"):
        wrapped = np.cumsum(x.astype(np.int64), axis=1).astype(np.int32)  # two's complement
    np.testing.assert_array_equal(js, wrapped)
    keys = _keys(js.astype(np.int64), q, lo, hi, seed=4)
    csum, cmax, idx = scan_check.rows_scan(torch.from_numpy(x), torch.from_numpy(keys), lo, hi)
    np.testing.assert_array_equal(csum.numpy(), js)
    np.testing.assert_array_equal(cmax.numpy(), jm)
    np.testing.assert_array_equal(cmax.numpy(), np.maximum.accumulate(x, axis=1))
    for r in range(x.shape[0] if q else 0):
        want = [max(i for i in range(lo, hi) if js[r, i] <= k) for k in keys[r]]
        np.testing.assert_array_equal(idx[r].numpy(), want)


def test_rows_scan_no_rows():
    x = torch.zeros((0, 2048), dtype=torch.int32)
    csum, cmax, idx = scan_check.rows_scan(x, torch.zeros((0, 7), dtype=torch.int32))
    assert csum.shape == cmax.shape == (0, 2048) and idx.shape == (0, 7)
