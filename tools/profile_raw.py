"""Per-stage timing for the raw-H2D device unpack (ops.unpack_device).

Stages timed as separate jitted programs over device-staged inputs (each
call ending in block_until_ready), so their sum over-counts shared intermediates
slightly, but per-stage weights identify the bottleneck:

  exp      unpack_exponents     (gather + group decode + setter resolve)
  alloc    allocate_rows        (band psd + excitation + mask -> bap)
  cplco    unpack_cplco         (gather + phase parity)
  mant     unpack_mantissas     (lattice cumsums + gather + dequant)
  full     unpack_blocks        (everything above in one program)
  pipe     raw_batched_pipeline (unpack + decode + int16)

Usage: python tools/profile_raw.py [batch] [nframes]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(HERE, "tests", "golden")


def main():
    from ac3acm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    nframes = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    import jax
    import jax.numpy as jnp
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.host.native import SideinfoBatchParser
    from ac3acm_tpu.models.decoder import StreamFormat, steady_ok
    from ac3acm_tpu.ops import unpack_device as U
    from ac3acm_tpu.parallel.pipeline import (init_batched_carry,
                                              raw_batched_pipeline)

    with open(os.path.join(GOLDEN, "bench_51_448.ac3"), "rb") as f:
        es = f.read()
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    sp = SideinfoBatchParser(1, nthreads=1)
    r = sp.parse([es * ((nframes // 8) + 1)], nframes, flags, 1.0, 384.0)
    assert int(r["nframes"][0]) == nframes
    mb = max(-(-int(r["fsizes"][0].max()) // 128) * 128, 128)
    fu8_1 = r["frames"][0, :, :mb]
    recs = r["recs"][0]
    meta1 = U.prune_raw_meta(
        {k: np.ascontiguousarray(recs[k]) for k in recs.dtype.names})
    fmt = StreamFormat(acmod=int(r["fmt"][0, 0, 0]),
                       output=int(r["fmt"][0, 0, 1]),
                       slev_zero=bool(r["fmt"][0, 0, 2]),
                       chanbias=int(recs[0]["chanbias"]))
    steady = steady_ok(fmt, {"blksw": meta1["blksw"].astype(bool),
                             "coeff": meta1["coeff"]})
    lo = steady and not meta1["blksw"].any()

    def bcast(x):
        x = jnp.asarray(x)
        return jax.jit(lambda a: jnp.broadcast_to(
            a[None], (batch,) + a.shape).copy())(x)

    fu8 = bcast(fu8_1)
    meta_h = {k: bcast(v) for k, v in meta1.items()}
    bias = jnp.full((batch, 6 * nframes), 384.0, jnp.float32)
    cpl_fc = U.static_cpl_fc(meta1)
    plan = U.plan_from_meta(meta1, fmt.nfchans, cpl_fc,
                            U.static_exp_pts(meta1),
                            U.static_alloc_pts(meta1))
    print(f"plan: {plan}, steady={steady}, long_only={lo}, "
          f"seg={plan.seg}, MB={mb}")

    carry = U.init_unpack_carry(batch)

    def timed(name, fn, *args, reps=5):
        f = jax.jit(fn)
        out = jax.block_until_ready(f(*args))
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(f(*args))
            best = min(best, time.perf_counter() - t0)
        print(f"{name:8s} {best * 1000:8.2f} ms")
        return out, best

    wm = jax.jit(U.widen_meta)(meta_h)

    def stage_exp(fu8, meta, ce):
        return U.unpack_exponents(fu8, meta, ce, plan)[0]

    exp, t_exp = timed("exp", stage_exp, fu8, wm, carry["exp"])

    def stage_alloc(exp, meta):
        return U.allocate_rows(exp, meta, plan)

    bap, t_alloc = timed("alloc", stage_alloc, exp, wm)

    if plan.has_cpl:
        def stage_cpl(fu8, meta, cc):
            return U.unpack_cplco(fu8, meta, cc)[0]
        cplco, t_cpl = timed("cplco", stage_cpl, fu8, wm, carry["cplco"])
    else:
        cplco = None

    def stage_mant(fu8, exp, bap, cplco, meta, dp):
        return U.unpack_mantissas(fu8, exp, bap, cplco, meta, dp, plan)[0]

    timed("mant", stage_mant, fu8, exp, bap, cplco, wm, carry["dpos"])

    def stage_full(fu8, meta, c, bias):
        return U.unpack_blocks(fu8, meta, c, bias, nfch=fmt.nfchans,
                               cpl_fc=cpl_fc)[1]

    timed("full", stage_full, fu8, meta_h, carry, bias)

    fn = raw_batched_pipeline(fmt, emit_int16=True, steady=steady,
                              long_only=lo, cpl_fc=cpl_fc,
                              exp_pts=plan.exp_pts,
                              alloc_pts=plan.alloc_pts)
    state = (U.init_unpack_carry(batch), init_batched_carry(batch))
    jax.block_until_ready(fn(state, fu8, meta_h, bias))
    best = 1e9
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(state, fu8, meta_h, bias))
        best = min(best, time.perf_counter() - t0)
    xrt = batch * nframes * 6 * 256 / 48000.0 / best
    print(f"{'pipe':8s} {best * 1000:8.2f} ms   ({xrt:.0f}x realtime)")


if __name__ == "__main__":
    main()
