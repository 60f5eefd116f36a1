"""Randomized correctness of the scan and compaction primitives
(`utils.scans`) and of the operators built on them, against numpy oracles:
hundreds of random masks, adversarial patterns (all-zero, all-one,
alternating, runs straddling power-of-two boundaries), long segments and
reverse scans."""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp

import arrow_tpu as at
from arrow_tpu import compute as ac
from arrow_tpu.table import RecordBatch
from arrow_tpu.utils.scans import segmented_scan, shift_cummax, stable_partition


def _check_compact(data: np.ndarray, mask: np.ndarray):
    (out,) = stable_partition(jnp.asarray(mask), [jnp.asarray(data)])
    k = int(mask.sum())
    np.testing.assert_array_equal(np.asarray(out)[:k], data[mask])
    np.testing.assert_array_equal(np.asarray(out)[k:], data[~mask])


@pytest.mark.parametrize("n", [8192, 16384, 32768, 98304])
def test_compaction_fuzz_random_masks(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 2**31, n).astype(np.int32)
    trials = max(6, 98304 // n * 8)
    for _ in range(trials):
        p = rng.choice([0.001, 0.01, 0.1, 0.3, 0.5, 0.7, 0.9, 0.99, 0.999])
        mask = rng.random(n) < p
        _check_compact(data, mask)


@pytest.mark.parametrize("n", [8192, 65536])
def test_compaction_adversarial_masks(n):
    rng = np.random.default_rng(7)
    data = rng.integers(0, 2**31, n).astype(np.int32)
    patterns = [
        np.zeros(n, bool),
        np.ones(n, bool),
        np.arange(n) % 2 == 0,
        np.arange(n) % 2 == 1,
        np.arange(n) % 32 == 31,  # one bit per mask word
        np.arange(n) < 1,  # single first
        np.arange(n) == n - 1,  # single last
    ]
    block = min(n, 32768)
    straddle = np.zeros(n, bool)
    for b in range(block, n, block):
        straddle[b - 17 : b + 17] = True
    patterns.append(straddle)
    half = np.zeros(n, bool)
    half[n // 2 :] = True  # long false run then long true run
    patterns.append(half)
    for mask in patterns:
        _check_compact(data, mask)


def test_compaction_bitpattern_values():
    n = 8192
    rng = np.random.default_rng(3)
    data = rng.integers(-(2**31), 2**31, n).astype(np.int64).astype(np.int32)
    data[:4] = [0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    for p in (0.25, 0.75):
        mask = rng.random(n) < p
        _check_compact(data, mask)


# ------------------------------------------------------------- segmented scans


_COMBINE = {
    "add": lambda a, b: a + b,
    "max": jnp.maximum,
    "first": lambda a, b: a,
}


def _np_segscan(vals, starts, op):
    out = vals.astype(np.int64).copy()
    fns = {"add": lambda a, b: a + b, "max": max, "first": lambda a, b: a}
    f = fns[op]
    for i in range(1, len(vals)):
        if starts is None or not starts[i]:
            out[i] = f(out[i - 1], int(vals[i]))
    return out


@pytest.mark.parametrize("op", ["add", "max", "first"])
def test_segscan_fuzz_multiblock(op):
    n = 98304
    rng = np.random.default_rng(11)
    vals = rng.integers(0, 1000, n).astype(np.int32)
    for density in (0.0, 0.0001, 0.01, 0.3):
        starts = rng.random(n) < density
        starts[0] = True
        out = segmented_scan(jnp.asarray(vals), jnp.asarray(starts), _COMBINE[op])
        exp = _np_segscan(vals, starts, op)
        if op == "add":
            exp = exp.astype(np.int32)  # wrapping
        np.testing.assert_array_equal(np.asarray(out).astype(np.int64), exp.astype(np.int64))


def test_segscan_deep_carry_chain():
    # one segment over 2^17 rows: every shift step of the ladder contributes
    n = 8192 * 16
    vals = np.ones(n, np.int32)
    starts = np.zeros(n, bool)
    starts[0] = True
    out = segmented_scan(jnp.asarray(vals), jnp.asarray(starts), _COMBINE["add"])
    np.testing.assert_array_equal(np.asarray(out), np.arange(1, n + 1, dtype=np.int32))
    np.testing.assert_array_equal(np.asarray(jnp.cumsum(jnp.asarray(vals))), np.asarray(out))


@pytest.mark.parametrize("reverse", [False, True])
def test_shift_cummax_fuzz(reverse):
    rng = np.random.default_rng(19)
    for n in (1, 7, 8192, 40000):
        v = rng.integers(-(2**31), 2**31, n).astype(np.int32)
        got = np.asarray(shift_cummax(jnp.asarray(v), reverse=reverse))
        exp = (
            np.maximum.accumulate(v[::-1])[::-1] if reverse else np.maximum.accumulate(v)
        )
        np.testing.assert_array_equal(got, exp)


# --------------------------------------------- operators over many planes


def _mk_cols(rng, n, spec):
    """Build arrow columns per spec list of (kind, nullable)."""
    cols = {}
    oracle = {}
    for i, (kind, nullable) in enumerate(spec):
        name = f"c{i}"
        ok = rng.random(n) < 0.85 if nullable else None
        if kind == "w32":
            v = rng.integers(0, 2**31, n).astype(np.int32)
            cls, conv = at.Int32Array, int
        elif kind == "w64":
            v = rng.integers(-(2**62), 2**62, n).astype(np.int64)
            cls, conv = at.Int64Array, int
        else:
            v = rng.random(n) < 0.5
            cls, conv = at.BooleanArray, bool
        if nullable:
            col = cls.from_optional_slice([conv(x) if o else None for x, o in zip(v, ok)])
        else:
            col = cls.from_slice(v.tolist() if kind == "bool" else v)
        cols[name] = col
        oracle[name] = (v, ok)
    return cols, oracle


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_production_many_planes(seed):
    """A RecordBatch filter with eleven mixed columns (32-bit, 64-bit, bool,
    with and without validity) under adversarial masks."""
    rng = np.random.default_rng(seed)
    n = 16384
    spec = [
        ("w32", False), ("w32", True), ("w64", False), ("w64", True),
        ("bool", False), ("bool", True), ("w32", True), ("w32", False),
        ("w64", True), ("w32", True), ("bool", False),
    ]
    cols, oracle = _mk_cols(rng, n, spec)
    batch = RecordBatch(cols)
    masks = [
        rng.random(n) < 0.5,
        np.zeros(n, bool),
        np.ones(n, bool),
        np.arange(n) % 32 == 31,
    ]
    for mask in masks:
        out = ac.filter(batch, at.BooleanArray.from_slice(mask.tolist()))
        for name, (v, ok) in oracle.items():
            exp_v = v[mask]
            exp_ok = ok[mask] if ok is not None else np.ones(len(exp_v), bool)
            got = out[name].values()
            assert len(got) == exp_v.shape[0]
            for g, x, o in zip(got, exp_v, exp_ok):
                if o:
                    assert g == x, (name, g, x)
                else:
                    assert g is None


@pytest.mark.parametrize("nlimb", [1, 2, 4])
def test_groupby_dense_fuzz_limbs(nlimb):
    """Counts and sums over a dense [0, 4096) key domain, values of 1, 2
    and 4 bytes' width."""
    rng = np.random.default_rng(nlimb)
    n = 16384
    keys = rng.integers(0, 4096, n).astype(np.uint32)
    hi = min(2 ** (8 * nlimb) - 1, 2**31 - 1)
    vals = rng.integers(0, hi, n).astype(np.int64)
    out = ac.hash_aggregate(
        at.UInt32Array.from_slice(keys),
        [("c", None, "count"), ("s", at.Int64Array.from_slice(vals), "sum")],
    )
    counts = np.bincount(keys, minlength=4096)
    groups = np.flatnonzero(counts)
    exp = np.zeros(4096, np.int64)
    np.add.at(exp, keys, vals)
    np.testing.assert_array_equal(out["key"].raw_values(), groups)
    np.testing.assert_array_equal(out["c"].raw_values(), counts[groups])
    np.testing.assert_array_equal(out["s"].raw_values(), exp[groups])


def test_sort_runs_with_max_keys():
    """Concatenated sorted runs, runt final runs and INT32_MAX keys mixed
    with the padded tail sort stably with their payload."""
    rng = np.random.default_rng(17)
    for nruns, runlen in ((2, 8192), (3, 8192), (5, 8192), (2, 16384)):
        n = nruns * runlen - 100
        keys = np.sort(
            rng.integers(0, 2**31, (nruns, runlen)).astype(np.int32), axis=1
        ).ravel()[:n]
        keys[:5] = np.iinfo(np.int32).max
        pay = np.arange(n, dtype=np.int32)
        ok, op = ac.sort_by_key(at.Int32Array.from_slice(keys), at.Int32Array.from_slice(pay))
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(ok.raw_values(), keys[order])
        np.testing.assert_array_equal(op.raw_values(), pay[order])
