"""Device measurements behind PERF.md's bring-up findings.

    python tools/bringup_measure.py [raw] [filterbank] [encode]

  raw         raw-H2D device step (unpack + decode + int16, inputs staged
              on the device) at 256 and 1024 lanes x 16 frames: time,
              bytes moved (XLA's cost analysis and the algorithmic
              in+out bytes) and their rate against the H100's 3.35 TB/s;
  filterbank  the c2 decode step (4096 lanes x 64 frames, premixed
              5.1->2.0, int16) with the order-exact body and with the
              fast-mode HIGHEST matmul body;
  encode      device encode + pack at the c3 (1024 x 8 frames, 2.0/192)
              and c4 (512 x 8 frames, 5.1/640) shapes.

Every time is the median of 10 calls, each ending in block_until_ready,
after one warm-up call.  Runs on whatever JAX's default backend is; the
first line names it.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402

HBM_BPS = 3.35e12          # H100 SXM device memory bandwidth (data sheet)


def timed(fn, reps=10):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts)


def nbytes(tree):
    import jax
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def xla_bytes(jitted, *args):
    ca = jitted.lower(*args).compile().cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return float(ca.get("bytes accessed", float("nan")))


def measure_raw(batch, nframes=16):
    import jax
    import jax.numpy as jnp
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.host.native import SideinfoBatchParser
    from ac3acm_tpu.models.decoder import StreamFormat, steady_ok
    from ac3acm_tpu.ops.unpack_device import (init_unpack_carry,
                                              prune_raw_meta, static_cpl_fc,
                                              static_alloc_pts,
                                              static_exp_pts, static_emax)
    from ac3acm_tpu.parallel.pipeline import (init_batched_carry,
                                              raw_batched_pipeline)
    sp = SideinfoBatchParser(1, nthreads=1)
    r = sp.parse([bench.golden_es() * ((nframes // 8) + 1)], nframes,
                 T.A52_STEREO | T.A52_ADJUST_LEVEL, 1.0, 384.0)
    mb = max(-(-int(r["fsizes"][0].max()) // 128) * 128, 128)
    recs = r["recs"][0]
    meta1 = prune_raw_meta(
        {k: np.ascontiguousarray(recs[k]) for k in recs.dtype.names})
    fmt = StreamFormat(acmod=int(r["fmt"][0, 0, 0]),
                       output=int(r["fmt"][0, 0, 1]),
                       slev_zero=bool(r["fmt"][0, 0, 2]),
                       chanbias=int(recs[0]["chanbias"]))
    steady = steady_ok(fmt, {"blksw": meta1["blksw"].astype(bool),
                             "coeff": meta1["coeff"]})
    lo = steady and not meta1["blksw"].any()

    def bcast(x):
        return jnp.broadcast_to(jnp.asarray(x)[None],
                                (batch,) + np.shape(x)).copy()

    fu8 = bcast(r["frames"][0, :, :mb])
    meta = {k: bcast(v) for k, v in meta1.items()}
    bias = jnp.full((batch, 6 * nframes), 384.0, jnp.float32)
    fn = raw_batched_pipeline(fmt, emit_int16=True, steady=steady,
                              long_only=lo, cpl_fc=static_cpl_fc(meta1),
                              exp_pts=static_exp_pts(meta1),
                              alloc_pts=static_alloc_pts(meta1),
                              emax=static_emax(meta1))
    carry = (init_unpack_carry(batch), init_batched_carry(batch))
    med, best = timed(lambda: fn(carry, fu8, meta, bias))
    _, pcm = fn(carry, fu8, meta, bias)
    algo = nbytes((carry, fu8, meta, bias)) + nbytes(pcm)
    xb = xla_bytes(fn, carry, fu8, meta, bias)
    xrt = batch * nframes * 1536 / 48000.0 / med
    print(f"raw {batch}x{nframes}: median {med * 1e3:.3f} ms (min "
          f"{best * 1e3:.3f}), {xrt:.0f}x realtime; XLA bytes accessed "
          f"{xb / 1e6:.1f} MB -> {xb / med / 1e9:.1f} GB/s = "
          f"{100 * xb / med / HBM_BPS:.2f}% of 3.35 TB/s; in+out "
          f"{algo / 1e6:.1f} MB -> {algo / med / 1e9:.1f} GB/s = "
          f"{100 * algo / med / HBM_BPS:.3f}%", flush=True)


def measure_filterbank(batch=4096, nframes=64):
    for fast in (False, True):
        xrt, _ = bench.bench_config2_device(batch, nframes, fast=fast)
        dt = batch * nframes * 1536 / 48000.0 / xrt
        print(f"c2 {'fast' if fast else 'exact'} {batch}x{nframes}: "
              f"{dt * 1e3:.3f} ms best-of-5, {xrt:.0f}x realtime",
              flush=True)


def measure_encode(shapes=((2, 192, 1024, 8), (6, 640, 512, 8))):
    import jax.numpy as jnp
    from ac3acm_tpu.models.encoder import encode_pipeline_packed, make_config
    for ch, kbps, batch, nframes in shapes:
        cfg = make_config(48000, kbps * 1000, ch)
        pcm = bench._encode_pcm(ch, nframes).reshape(nframes, 1536, ch)
        dev = jnp.broadcast_to(jnp.asarray(pcm)[:, None],
                               (nframes, batch, 1536, ch)).copy()
        last = jnp.zeros((batch, ch, 256), jnp.int32)
        csnr = jnp.full((batch,), 40, jnp.int32)
        fn = encode_pipeline_packed(cfg)
        med, best = timed(lambda: fn(dev, last, csnr))
        xrt = batch * nframes * 1536 / 48000.0 / med
        print(f"encode+pack {ch}ch/{kbps} {batch}x{nframes}: median "
              f"{med * 1e3:.3f} ms (min {best * 1e3:.3f}), {xrt:.0f}x "
              f"realtime", flush=True)


def main():
    import jax
    from ac3acm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        card = "nvidia-smi unavailable"
    d = jax.devices()[0]
    print(f"{d.platform} {d.device_kind} x{len(jax.devices())}; {card}",
          flush=True)
    which = sys.argv[1:] or ["raw", "filterbank", "encode"]
    if "raw" in which:
        for b in (256, 1024):
            measure_raw(b)
    if "filterbank" in which:
        measure_filterbank()
    if "encode" in which:
        measure_encode()


if __name__ == "__main__":
    main()
