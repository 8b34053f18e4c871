#!/usr/bin/env python
"""Microbenchmark the heavy-geometry pre-stages at LOD-crowd scale.

Isolates, at n=1.17M packed slots / cap=197k (the LOD crowd's tight-cap
workload shape):
  * argsort-based stable partition (geometry.compact_triangles today)
    vs a cumsum+scatter permutation,
  * the binning global/binned argsort partition at cap slots,
  * the packed-u32 pair sort at cap*span_cap keys,
  * the stream gathers (setup rows + 128-wide payload rows) at
    cap*span_cap pairs.

JSON lines to stdout.  Evidence ledger for the round-3 compaction
rewrite.
"""

import json
import os
import sys
import time


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from softwarerenderer_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable_compile_cache()

import numpy as np


def timed(fn, *args, n=20):
    import jax
    jf = jax.jit(fn)
    out = jax.block_until_ready(jf(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = jf(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    import jax
    import jax.numpy as jnp

    N = 1_168_128          # packed slots (the LOD crowd)
    CAP = 196_864          # tight active cap
    SPAN = 8
    NTILES = 510           # 4K at 32x128 tiles

    rng = np.random.default_rng(0)
    valid = jnp.asarray(rng.random(N) < (CAP / 2 / N))
    key32 = jnp.asarray(rng.integers(0, 2**32, CAP * SPAN, dtype=np.uint32))
    payload = jnp.asarray(rng.random((CAP, 128), dtype=np.float32))
    payload_full = jnp.asarray(rng.random((N, 32), dtype=np.float32))
    setup = jnp.asarray(rng.random((16, CAP), dtype=np.float32))
    pair_idx = jnp.asarray(rng.integers(0, CAP, CAP * SPAN, dtype=np.int32))

    def rep(tag, ms):
        print(json.dumps({"tag": tag, "ms": round(ms * 1e3, 3)}), flush=True)

    # 1) argsort partition over N slots (compact_triangles today)
    def part_argsort(v):
        return jnp.argsort(jnp.where(v, 0, 1), stable=True)[:CAP]
    rep("partition_argsort_N", timed(part_argsort, valid))

    # 2) cumsum+scatter partition over N slots
    def part_scatter(v):
        pos = jnp.cumsum(v.astype(jnp.int32)) - 1
        tgt = jnp.where(v, pos, CAP)
        perm = jnp.zeros((CAP,), jnp.int32).at[tgt].set(
            jnp.arange(N, dtype=jnp.int32), mode="drop")
        return perm
    rep("partition_scatter_N", timed(part_scatter, valid))

    # equality check (prefix only: argsort tail ids differ, masked anyway)
    pa = np.asarray(jax.jit(part_argsort)(valid))
    psc = np.asarray(jax.jit(part_scatter)(valid))
    nv = int(np.sum(np.asarray(valid)))
    k = min(nv, CAP)
    print(json.dumps({"tag": "partition_equal_prefix",
                      "equal": bool(np.array_equal(pa[:k], psc[:k])),
                      "n_valid": nv}), flush=True)

    # 3) the same partitions at CAP slots (bin_triangles global split)
    validc = valid[:CAP]

    def part_argsort_cap(v):
        return jnp.argsort(jnp.where(v, 0, 1), stable=True)

    def part_scatter_cap(v):
        n = v.shape[0]
        ng = jnp.sum(v.astype(jnp.int32))
        posg = jnp.cumsum(v.astype(jnp.int32)) - 1
        posb = jnp.cumsum((~v).astype(jnp.int32)) - 1
        tgt = jnp.where(v, posg, ng + posb)
        return jnp.zeros((n,), jnp.int32).at[tgt].set(
            jnp.arange(n, dtype=jnp.int32))
    rep("partition_argsort_cap", timed(part_argsort_cap, validc))
    rep("partition_scatter_cap", timed(part_scatter_cap, validc))
    pa = np.asarray(jax.jit(part_argsort_cap)(validc))
    psc = np.asarray(jax.jit(part_scatter_cap)(validc))
    print(json.dumps({"tag": "partition_cap_equal",
                      "equal": bool(np.array_equal(pa, psc))}), flush=True)

    # 4) packed u32 pair sort at CAP*SPAN keys
    rep("pair_sort_u32", timed(lambda k: jnp.sort(k), key32))

    # 5) stream gathers at CAP*SPAN pairs
    rep("gather_setup_rows", timed(
        lambda s, i: jnp.take(s, i, axis=1), setup, pair_idx))
    rep("gather_payload_rows128", timed(
        lambda p, i: jnp.take(p, i, axis=0), payload, pair_idx))

    # 6) attr-style gathers at CAP rows from N-row tables (compaction cost)
    idx_cap = jnp.asarray(rng.integers(0, N, CAP, dtype=np.int32))
    rep("gather_attrs32_capfromN", timed(
        lambda p, i: jnp.take(p, i, axis=0), payload_full, idx_cap))

    # 7) full-N elementwise payload build (what deferring compaction costs)
    rep("elementwise_mask_N32", timed(
        lambda p, v: jnp.where(v[:, None], p, 0.0), payload_full, valid))


if __name__ == "__main__":
    main()
