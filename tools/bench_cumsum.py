"""Microbench: XLA cumsum/cummax vs blocked triangular-matmul cumsum.

The raw-unpack mantissa lattice runs several exclusive cumsums and
cummaxes along a seg=2688 lane axis of [L, S, seg] tensors.  XLA lowers
cumsum to a log-depth shifted-add chain (~12 full HBM passes); a blocked
form (intra-128 inclusive cumsum as ONE bf16 triangular matmul +
a tiny inter-block carry) should be HBM-bound at ~2 passes.  Exactness:
summands are small ints (0/1 flags, widths <= 16) -- exact in bf16 --
and f32 accumulation of < 2^24 totals is exact.

Usage: python tools/bench_cumsum.py [L] [S] [seg]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def blocked_cumsum_excl(x, block=512):
    """Exclusive cumsum along the last axis via triangular bf16 matmul."""
    *lead, seg = x.shape
    G = seg // block
    xb = x.reshape(*lead, G, block).astype(jnp.bfloat16)
    tri = jnp.triu(jnp.ones((block, block), jnp.bfloat16), 1)  # exclusive
    intra = jax.lax.dot_general(
        xb, tri, dimension_numbers=(((xb.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    sums = jnp.sum(xb.astype(jnp.float32), axis=-1)
    base = jnp.cumsum(sums, axis=-1) - sums              # [*, G]
    out = (intra + base[..., None]).astype(jnp.int32)
    return out.reshape(*lead, seg)


def main():
    from ac3acm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    L = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    S = int(sys.argv[2]) if len(sys.argv) > 2 else 96
    seg = int(sys.argv[3]) if len(sys.argv) > 3 else 2688
    key = jax.random.PRNGKey(0)
    x = jax.random.randint(key, (L, S, seg), 0, 17, jnp.int32)
    x = jax.device_put(x)

    def timed(name, f, *a, reps=5):
        g = jax.jit(f)
        out = jax.block_until_ready(g(*a))
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(g(*a))
            best = min(best, time.perf_counter() - t0)
        print(f"{name:24s} {best * 1000:8.2f} ms")
        return np.asarray(out)

    ref = timed("xla_cumsum_excl", lambda v: jnp.cumsum(v, -1) - v, x)
    for blk in (128, 256, 512, 672):
        if seg % blk:
            continue
        got = timed(f"matmul_cumsum_b{blk}",
                    lambda v, b=blk: blocked_cumsum_excl(v, b), x)
        assert np.array_equal(ref, got), f"mismatch at block {blk}"
    # 4 counters in one batched matmul (stack on a new leading axis)
    x4 = jnp.stack([x & 1, (x >> 1) & 1, (x >> 2) & 1, x % 17], 0)
    timed("matmul_cumsum_4x_b128",
          lambda v: blocked_cumsum_excl(v, 128), x4)
    timed("xla_cumsum_4x",
          lambda v: jnp.cumsum(v, -1) - v, x4)
    timed("xla_cummax", lambda v: jax.lax.cummax(v, axis=2), x)
    print("exact: OK")


if __name__ == "__main__":
    main()
