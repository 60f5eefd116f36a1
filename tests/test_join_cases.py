"""Join cases against a plain numpy oracle: every key-equal (probe, build)
pair exactly once, for 64-bit keys above and below 2^32 and small key
domains with duplicates on both sides."""

import collections

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import compute as C


def _pairs(bk, pk):
    bmap = collections.defaultdict(list)
    for i, k in enumerate(bk.tolist()):
        bmap[k].append(i)
    return sorted((j, i) for j, k in enumerate(pk.tolist()) for i in bmap.get(k, ()))


def _check(bk, pk, cls=at.UInt64Array):
    pi, bi, t = C.join_indices(cls.from_slice(bk), cls.from_slice(pk))
    exp = _pairs(bk, pk)
    assert t == len(exp)
    assert sorted(zip(pi.values(), bi.values())) == exp


def test_wide_keys_with_misses():
    rng = np.random.default_rng(6)
    nb, npr = 6000, 9000  # pads to 8192 / 16384
    bk = rng.integers(0, 2**40, nb).astype(np.uint64)
    pk = np.concatenate(
        [bk[rng.integers(0, nb, npr - 1000)], rng.integers(2**41, 2**42, 1000).astype(np.uint64)]
    )
    rng.shuffle(pk)
    _check(bk, pk)


def test_small_domain_duplicates():
    rng = np.random.default_rng(21)
    _check(rng.integers(0, 40, 300).astype(np.uint64), rng.integers(0, 40, 500).astype(np.uint64))


@pytest.mark.parametrize("cls", [at.UInt64Array, at.UInt32Array])
def test_keys_below_2_32(cls):
    """u64 keys whose high word is zero join like the same keys as u32."""
    rng = np.random.default_rng(5)
    n = 8192
    dt = np.uint64 if cls is at.UInt64Array else np.uint32
    _check(rng.integers(0, 1000, n).astype(dt), rng.integers(0, 1000, n).astype(dt), cls)
