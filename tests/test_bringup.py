"""Each operator has one route, and nothing hides the device: retired
`method=` values raise, no public op reaches a Pallas kernel, the compile
cache goes where JAX or the checkout says, peak bandwidth is known only for
known devices, and the smoke script and the multi-device dry run fail instead
of falling back to the CPU.  The smoke script's phases also run here at small
sizes, so their numpy checks are tested before they run on a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import compute as C
from arrow_tpu.errors import OperationNotSupported
from arrow_tpu.table import RecordBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _u32(vals):
    return at.UInt32Array.from_slice(np.asarray(vals, np.uint32))


_RETIRED = [
    ("filter", "pallas", lambda m: C.filter(_u32([1, 2, 3]), at.BooleanArray.from_slice([True] * 3), method=m)),
    ("sort", "radix", lambda m: C.sort(_u32([3, 1, 2]), method=m)),
    ("sort", "merge", lambda m: C.sort(_u32([3, 1, 2]), method=m)),
    ("sort_by_key", "radix", lambda m: C.sort_by_key(_u32([3, 1, 2]), _u32([0, 1, 2]), method=m)),
    ("sort_by_key", "merge", lambda m: C.sort_by_key(_u32([3, 1, 2]), _u32([0, 1, 2]), method=m)),
    ("hash_aggregate", "mxu", lambda m: C.hash_aggregate(_u32([1, 1, 2]), [("n", None, "count")], method=m)),
    ("hash_aggregate", "partition", lambda m: C.hash_aggregate(_u32([1, 1, 2]), [("n", None, "count")], method=m)),
    ("hash_aggregate", "radix", lambda m: C.hash_aggregate(_u32([1, 1, 2]), [("n", None, "count")], method=m)),
]


@pytest.mark.parametrize("op,method,call", _RETIRED, ids=[f"{o}-{m}" for o, m, _ in _RETIRED])
def test_retired_method_raises(op, method, call):
    with pytest.raises(OperationNotSupported, match=method):
        call(method)


def test_no_public_op_reaches_pallas(monkeypatch):
    """With `pallas_call` rigged to raise, every operator still runs, and a
    group-by over dense keys in [0, 1000) gives the sort program's result."""
    import jax.experimental.pallas as pl

    def boom(*a, **k):
        raise AssertionError("a Pallas kernel was reached")

    monkeypatch.setattr(pl, "pallas_call", boom)
    rng = np.random.default_rng(0)
    n = 10_000
    keys = rng.integers(0, 1000, n).astype(np.uint32)
    vals = rng.integers(-50, 50, n).astype(np.int32)
    ka, va = _u32(keys), at.Int32Array.from_slice(vals)
    mask = at.BooleanArray.from_slice(vals > 0)

    agg = C.hash_aggregate(ka, [("s", va, "sum"), ("n", None, "count")])
    uk = np.unique(keys)
    np.testing.assert_array_equal(agg["key"].raw_values(), uk)
    np.testing.assert_array_equal(agg["n"].raw_values(), np.bincount(keys)[uk])
    np.testing.assert_array_equal(
        agg["s"].raw_values(), np.bincount(keys, weights=vals).astype(np.int64)[uk]
    )
    np.testing.assert_array_equal(C.filter(va, mask).raw_values(), vals[vals > 0])
    batch = RecordBatch({"k": ka, "v": va})
    assert C.filter(batch, mask).num_rows == int((vals > 0).sum())
    np.testing.assert_array_equal(C.sort(ka).raw_values(), np.sort(keys))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(C.argsort(ka).raw_values(), order)
    _, sp = C.sort_by_key(ka, va)
    np.testing.assert_array_equal(sp.raw_values(), vals[order])
    _, _, lex = C.lex_sort([ka, va])
    np.testing.assert_array_equal(lex.raw_values(), np.lexsort((vals, keys)))
    _, _, t = C.join_indices(ka, ka)
    assert t == int((np.bincount(keys) ** 2).sum())
    assert C.hash_join(batch, batch, "k", "k").num_rows == t


def _import_cache_dir(env):
    out = subprocess.run(
        [sys.executable, "-c",
         "import arrow_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def _gpu_like_env():
    env = dict(os.environ)
    for var in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR"):
        env.pop(var, None)
    return env


def test_compile_cache_defaults_to_checkout():
    assert _import_cache_dir(_gpu_like_env()) == os.path.join(REPO, ".jax_cache")


def test_compile_cache_follows_jax_env(tmp_path):
    env = _gpu_like_env()
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    assert _import_cache_dir(env) == str(tmp_path)


@pytest.mark.parametrize(
    "kind,rate",
    [("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12), ("NVIDIA H100 NVL", 3.9e12)],
)
def test_hbm_bandwidth_known_kinds(kind, rate):
    assert bench._hbm_bandwidth_bytes(kind) == rate


def test_hbm_bandwidth_unknown_kind_raises():
    with pytest.raises(ValueError, match="Unknown Accelerator"):
        bench._hbm_bandwidth_bytes("Unknown Accelerator")


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO, "chip_smoke.py")
    assert r.returncode != 0
    assert "found no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_dryrun_multichip_raises_when_short():
    import __graft_entry__ as G

    with pytest.raises(RuntimeError, match="needs 64"):
        G.dryrun_multichip(64)


def test_dryrun_multichip_on_virtual_devices(capsys):
    import __graft_entry__ as G

    G.dryrun_multichip(4)
    assert "dryrun_multichip(4): ok" in capsys.readouterr().out


_SMALL_PHASES = [
    (chip_smoke.phase_elementwise, dict(n=50_000)),
    (chip_smoke.phase_query, dict(n=1 << 15, n_keys=1 << 10)),
    (chip_smoke.phase_groupby_dense, dict(n=1 << 15)),
    (chip_smoke.phase_sort, dict(n=1 << 15, n_i64=1 << 14)),
    (chip_smoke.phase_join, dict(n=1 << 14)),
]


@pytest.mark.parametrize(
    "phase,kw", _SMALL_PHASES, ids=[p.__name__ for p, _ in _SMALL_PHASES]
)
def test_chip_smoke_phase_small(phase, kw, capsys):
    checks = phase(np.random.default_rng(0), **kw)
    assert checks.items and all(err <= tol for _, err, tol in checks.items)
    assert "first_call_s=" in capsys.readouterr().out


def test_chip_smoke_distributed_small(capsys):
    checks = chip_smoke.phase_distributed(
        np.random.default_rng(0), 4, rows_per_card=1 << 13, n_keys=1 << 10
    )
    names = {n for n, _, _ in checks.items}
    assert {"filter_k", "partition_rows", "agg_sums", "join_pairs", "sort_rows"} <= names
    assert "[distributed_sort]" in capsys.readouterr().out


def test_chip_smoke_checks_catch_errors():
    c = chip_smoke.Checks()
    c.exact("same", np.float32([1.0, -0.0]), np.float32([1.0, -0.0]))
    with pytest.raises(chip_smoke.CheckFailed, match="differ|exceeds"):
        c.exact("bits", np.float32([0.0]), np.float32([-0.0]))
    with pytest.raises(chip_smoke.CheckFailed, match="shape"):
        c.exact("shape", np.zeros(3), np.zeros(4))
    c.rel("close", [1.00001], [1.0], 1e-4)
    with pytest.raises(chip_smoke.CheckFailed, match="exceeds"):
        c.rel("far", [1.001], [1.0], 1e-4)
    with pytest.raises(chip_smoke.CheckFailed):
        c.equal("count", 5, 6)


def test_join_reference_matches_brute_force():
    rng = np.random.default_rng(3)
    bk = rng.integers(0, 30, 200).astype(np.uint64)
    pk = rng.integers(0, 40, 300).astype(np.uint64)
    probe, build = chip_smoke.join_reference(bk, pk)
    exp = [(j, i) for j in range(pk.size) for i in range(bk.size) if pk[j] == bk[i]]
    assert list(zip(probe.tolist(), build.tolist())) == exp
