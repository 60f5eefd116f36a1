"""1B-row distributed sort CORRECTNESS run on the 8-virtual-device CPU mesh.

The 1B-row BASELINE sort config is an N-device configuration; this runs the
`distributed_sort` program — sampled splitters, range-partition all-to-all,
local sorts — over 8 virtual CPU devices at 2^27 rows/shard (2^30 ~ 1.07B
rows total) and verifies:

  1. row conservation (total count unchanged),
  2. global sortedness (each shard locally sorted AND shard max <= next
     shard min),
  3. content preservation (u64 key checksum unchanged).

Writes DIST_SORT_1B.json.  Run detached: needs ~40+ GB RAM and tens of
minutes on the 2-vCPU host.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import arrow_tpu  # noqa: E402,F401
from arrow_tpu import dtypes as dt  # noqa: E402
from arrow_tpu.parallel import distributed_ops as D  # noqa: E402
from arrow_tpu.parallel.mesh import MeshRuntime  # noqa: E402
from arrow_tpu.parallel.sharding import ShardedBatch, ShardedColumn  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def main() -> None:
    t0 = time.time()
    rows_per_shard = int(os.environ.get("DIST1B_ROWS", str(1 << 27)))
    with_payload = os.environ.get("DIST1B_PAYLOAD", "0") == "1"
    outcap_num = int(os.environ.get("DIST1B_OUTCAP_NUM", "3"))  # x/2 of cap
    rt = MeshRuntime.create()
    p = rt.num_shards
    total_rows = p * rows_per_shard
    print(f"mesh={p} shards x {rows_per_shard} rows = {total_rows}", flush=True)

    sharding = NamedSharding(rt.mesh, P(rt.axis, None))

    @jax.jit
    def gen(key):
        ks = jax.random.split(key, p)
        def per(k):
            a = jax.random.randint(
                k, (1, rows_per_shard), 0, 1 << 31, dtype=jnp.uint32
            )
            b = jax.random.randint(
                k, (1, rows_per_shard), 0, 1 << 31, dtype=jnp.uint32
            )
            return a, b
        outs = [per(ks[i]) for i in range(p)]
        keys = jnp.concatenate([o[0] for o in outs], axis=0)
        vals = jnp.concatenate([o[1] for o in outs], axis=0)
        return keys, vals

    keys, vals = gen(jax.random.key(0))
    keys = jax.device_put(keys, sharding)
    if with_payload:
        vals = jax.device_put(vals, sharding)
    else:
        # the 1B x (key+payload) configuration was measured to need >125 GB
        # of HOST RAM in this CPU simulation (oom-killed at 130 GB RSS —
        # XLA:CPU materializes several plane generations across the
        # range-partition exchange and local sorts).  On the real N-host
        # target the same config is trivial (1B x 8 B = 8 GB over N chips);
        # the single-host simulation runs the key column, which exercises
        # the identical splitter/exchange/sort program shape.
        del vals
    counts = jax.device_put(
        jnp.full((p,), rows_per_shard, jnp.int32), NamedSharding(rt.mesh, P(rt.axis))
    )
    ksum_in = int(jnp.sum(keys.astype(jnp.uint64), dtype=jnp.uint64))
    print(f"[{time.time()-t0:.0f}s] generated; key checksum {ksum_in}", flush=True)

    cols = {"k": ShardedColumn(keys, None, dt.ArrowType.UINT32)}
    if with_payload:
        cols["v"] = ShardedColumn(vals, None, dt.ArrowType.UINT32)
    sb = ShardedBatch(cols, counts, rt)
    t1 = time.time()
    out = D.distributed_sort(
        sb, "k", out_capacity=rows_per_shard * outcap_num // 2
    )
    jax.block_until_ready(out.columns["k"].data)
    sort_s = time.time() - t1
    print(f"[{time.time()-t0:.0f}s] distributed_sort done in {sort_s:.0f}s", flush=True)

    ok_data = out.columns["k"].data
    ocounts = np.asarray(out.counts)
    assert int(ocounts.sum()) == total_rows, (ocounts, total_rows)

    # per-shard checks without materializing 1B rows on host at once
    prev_max = -1
    ksum_out = 0
    sorted_ok = True
    for s in range(p):
        c = int(ocounts[s])
        shard = np.asarray(ok_data[s])[:c].astype(np.uint32)
        if c:
            if not (np.diff(shard.astype(np.int64)) >= 0).all():
                sorted_ok = False
            if int(shard[0]) < prev_max:
                sorted_ok = False
            prev_max = int(shard[-1])
            ksum_out += int(shard.astype(np.uint64).sum())
        del shard
    report = {
        "rows_total": total_rows,
        "rows_per_shard": rows_per_shard,
        "shards": p,
        "sort_seconds_cpu_mesh": sort_s,
        "row_conservation_ok": True,
        "globally_sorted_ok": bool(sorted_ok),
        "key_checksum_ok": ksum_out == ksum_in,
        "with_payload": with_payload,
        "note": "correctness run on 8 virtual CPU devices; the 1B config is "
        "the N-device deployment shape. The k+v variant of this CPU simulation needs >125 GB host RAM "
        "(oom-killed at 130 GB RSS) while the real N-chip config is ~8 GB "
        "of data; key-only exercises the identical program shape.",
    }
    assert sorted_ok and ksum_out == ksum_in, report
    with open(os.path.join(REPO, "DIST_SORT_1B.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
