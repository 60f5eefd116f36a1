"""Canonical user-facing flow (≙ `examples/simple.rs:12-77`):
eager ops, then the same expression as one pipelined (fused) program."""

import numpy as np

import arrow_tpu as at
from arrow_tpu import kernels as K


def run_eager_ops():
    lhs = at.Float32Array.from_slice([1.0, 2.0, 3.0, 4.0])
    rhs = at.Float32Array.from_slice([10.0])  # 1-row array used as scalar

    added = K.add_scalar_dyn(lhs, rhs)
    print("add_scalar:", added.values())

    multiplied = K.mul_scalar_dyn(added, rhs)
    print("mul_scalar:", multiplied.values())


def run_compute_pipeline_ops():
    lhs = at.Float32Array.from_slice([1.0, 2.0, 3.0, 4.0])
    rhs = at.Float32Array.from_slice([10.0])

    with at.ComputePipeline() as pipeline:
        r1 = K.add_scalar_op_dyn(lhs, rhs, pipeline)
        r2 = K.mul_scalar_op_dyn(r1, rhs, pipeline)
    # ONE fused XLA dispatch for both ops (≙ one queue.submit)
    print("pipelined add:", r1.values())
    print("pipelined add+mul:", r2.values())


def run_operator_tier():
    from arrow_tpu import compute as C
    from arrow_tpu.table import RecordBatch

    rng = np.random.default_rng(0)
    n = 1 << 16
    batch = RecordBatch.from_numpy(
        {
            "key": rng.integers(0, 100, n).astype(np.uint32),
            "value": rng.standard_normal(n).astype(np.float32),
        }
    )
    mask = K.gt_scalar(batch["value"], 0.0)
    kept = C.filter(batch, mask)
    agg = C.hash_aggregate(
        kept["key"], [("total", kept["value"], "sum"), ("rows", None, "count")]
    )
    print(f"filtered {kept.num_rows}/{n} rows into {agg.num_rows} groups")


if __name__ == "__main__":
    run_eager_ops()
    run_compute_pipeline_ops()
    run_operator_tier()
