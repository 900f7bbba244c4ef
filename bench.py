"""Benchmarks: the five configs (BASELINE.md) + the end-to-end decode path.

Prints ONE JSON line:
  {"metric", "value", "unit", "device": {...}, "configs": {...}}

The headline value is config 2's device-pipeline throughput (batched
5.1->2.0 decode, DRC on, int16 out, inputs staged on device).  The
"configs" dict carries the full picture, including the *end-to-end*
bytes-to-PCM figure (host parse + premix + H2D + device + D2H int16
fetch, all timed) and the host parse throughput per core that bounds it.
"device" names the platform, device kind and device count the numbers
were taken on.

Timing ends every measured call in block_until_ready; best of N
steady-state calls after identical warmup.  Any failed config makes the
exit code non-zero (its error is in the JSON).

Knobs: BENCH_BATCH (default 4096), BENCH_FRAMES (64), BENCH_CONFIGS
(comma list, default "1,2,e2e,3,4,5,hetero"), BENCH_E2E_BATCH (256).
"""
from __future__ import annotations

import json
import os
import sys
import time

from ac3acm_tpu.utils.cache import (enable_compile_cache,  # noqa: E402
                                    raise_stack_limit)

raise_stack_limit()       # big executables overflow 8 MB during cache IO

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def golden_es(name="bench_51_448.ac3"):
    return open(os.path.join(GOLDEN, name), "rb").read()


def frames_of(es, n):
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.host.parse import syncinfo
    out, pos = [], 0
    while len(out) < n:
        if pos + 7 > len(es):
            pos = 0
        size, _, _, _ = syncinfo(es[pos:pos + 7])
        assert size
        out.append(es[pos:pos + size])
        pos += size
    return out


def bench_link(mb=16):
    """Measured host<->device link bandwidth (MB/s each way), the
    normalizer for the e2e and transcode configs."""
    import jax
    buf = np.zeros(mb * 1 << 20, np.uint8)
    dev = jax.device_put(buf)          # warm both directions
    _ = np.asarray(dev)
    t0 = time.perf_counter()
    dev = jax.device_put(buf)
    dev.block_until_ready()
    h2d = time.perf_counter() - t0
    t0 = time.perf_counter()
    _ = np.asarray(dev)
    d2h = time.perf_counter() - t0
    log(f"link: H2D {mb / h2d:.1f} MB/s, D2H {mb / d2h:.1f} MB/s")
    return round(mb / h2d, 1), round(mb / d2h, 1)


def best_of(fn, warmup=2, reps=5):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times), times


# ---------------------------------------------------------------------------
# config 1: single-stream 5.1 -> 2.0 decode, bit-matching CPU mode
# ---------------------------------------------------------------------------

def bench_config1():
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.host.native import NativeDecoder
    es = b"".join(frames_of(golden_es(), 128))
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    d = NativeDecoder()

    def run():
        out = d.decode_stream(es, flags, 1.0, 384.0)
        assert out.shape[0] == 128 * 6
    dt, _ = best_of(run, warmup=1, reps=3)
    xrt = 128 * 6 * 256 / 48000.0 / dt
    log(f"config1 single-stream CPU decode: {xrt:.0f}x realtime")

    # the reference's own headline path on the same host/core: liba52
    # compiled from /root/reference (the differential-test oracle build)
    ref_xrt = None
    try:
        from tests.refbuild import get_ref
        ref = get_ref()

        def run_ref():
            ref.decode_stream(es, flags, level=1.0, bias=384.0)
        dt_r, _ = best_of(run_ref, warmup=1, reps=3)
        ref_xrt = 128 * 6 * 256 / 48000.0 / dt_r
        log(f"config1 reference liba52 (same host): {ref_xrt:.0f}x realtime "
            f"-> ours is {xrt / ref_xrt:.2f}x faster single-core")
    except Exception as e:                      # oracle build unavailable
        log(f"config1 reference comparison skipped: {e}")
    return round(xrt, 1), (round(ref_xrt, 1) if ref_xrt else None)


# ---------------------------------------------------------------------------
# config 2: batched 5.1 decode + DRC + 2.0 downmix (device pipeline)
# ---------------------------------------------------------------------------

def load_blocks(nframes: int):
    """Real coded content from the golden 5.1 stream, tiled to nframes."""
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.host.native import NativeParser
    es = golden_es()
    p = NativeParser()
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    blocks, meta = p.decode_frames(es * ((nframes // 8) + 1), nframes,
                                   flags, 1.0, 384.0)
    blocks = {k: v[: nframes * 6] for k, v in blocks.items()}
    return blocks, meta


def bench_config2_device(batch, nframes, fast=False):
    """fast=False (default): the CONTRACTUAL order-exact path (package
    ACCURACY='reference', bit-exact vs the compiled reference).
    fast=True: the opt-in HIGHEST-precision matmul path (0.02/0.002 LSB
    contract) -- recorded as c2_fast_device_xrt."""
    import jax
    import jax.numpy as jnp
    from ac3acm_tpu.models.decoder import (StreamFormat, premix_blocks,
                                           steady_ok)
    from ac3acm_tpu.parallel.pipeline import (batched_pipeline,
                                              init_batched_carry)
    nblk = nframes * 6
    blocks1, meta = load_blocks(nframes)
    fmt = StreamFormat(acmod=meta["acmod"], output=meta["output"],
                       slev_zero=meta["slev"] == 0.0,
                       chanbias=meta["chanbias"])
    steady = steady_ok(fmt, blocks1)
    long_only = steady and not np.asarray(blocks1["blksw"]).any()
    premixed = steady and fmt.nf_out < fmt.nfchans

    # ship one stream's chunk and materialize the full batch buffer on
    # device: the timed loop reads a real batch-sized tensor from HBM
    def bcast(x):
        x = jnp.asarray(x)
        return jax.jit(
            lambda a: jnp.broadcast_to(a[None], (batch,) + a.shape)
            .copy())(x)

    blocks1p = premix_blocks(fmt, blocks1) if premixed else blocks1
    blocks = jax.tree.map(bcast, blocks1p)
    fn = batched_pipeline(fmt, emit_int16=True, steady=steady,
                          long_only=long_only, premixed=premixed,
                          exact=(not fast))
    state = {"c": init_batched_carry(batch)}

    def run():
        state["c"], pcm = fn(state["c"], blocks)
        jax.block_until_ready(pcm)

    dt, times = best_of(run, warmup=1, reps=5)
    xrt = batch * nblk * 256 / 48000.0 / dt
    mode = "fast (matmul)" if fast else "reference (order-exact)"
    log(f"config2 device pipeline [{mode}]: {batch} x {nframes}f, best "
        f"{dt * 1000:.1f} ms ({[round(t * 1000) for t in times]}), "
        f"{xrt:.0f}x realtime")
    return round(xrt, 1), batch * nframes / dt


# ---------------------------------------------------------------------------
# config 2-e2e: bytes in -> int16 PCM on host, everything timed
# ---------------------------------------------------------------------------

def bench_config2_e2e(batch, chunk_frames, nchunks=4):
    """Bytes in -> int16 PCM, everything timed: native parse + premix,
    H2D, device pipeline, and output consumption.

    Two sink modes, mirroring the reference CLI's own speed-test split:
      * "null" -- PCM is reduced on device (a52dec -o null analogue; also
        the transcode topology, where PCM never leaves the chip);
      * "fetch" -- full int16 PCM pulled to the host (a52dec -o float
        analogue).
    """
    import jax
    import jax.numpy as jnp
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.parallel.pipeline import BatchedDecoder
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    base = frames_of(golden_es(), 8)
    total = chunk_frames * nchunks
    # distinct per-lane byte streams: rotated frame start per lane
    lanes = [b"".join(base[i % 8:] + base[:i % 8])
             * ((total // 8) + 1) for i in range(min(batch, 8))]
    lane_bytes = [lanes[i % 8][: total * len(base[0]) + 7]
                  for i in range(batch)]
    chk = jax.jit(lambda x: jnp.sum(x.astype(jnp.int32)))

    def cycle(fetch, compact=False, parser="native"):
        dec = BatchedDecoder(batch, flags, bias=384.0, emit_int16=True,
                             parser=parser, compact_h2d=compact)
        for i in range(batch):
            dec.feed(i, lane_bytes[i])
        prev = None
        nfr = 0
        for _ in range(nchunks):
            r = dec.decode_available(max_frames=chunk_frames)
            if prev is not None:
                # consume the previous chunk's PCM (device work overlaps
                # with this chunk's host parse)
                _ = np.asarray(prev[0]) if fetch else int(chk(prev[0]))
            if r is None:
                break
            nfr += r[1].shape[1]
            prev = r
        if prev is not None:
            _ = np.asarray(prev[0]) if fetch else int(chk(prev[0]))
        return nfr

    out = {}
    for mode, fetch, compact, parser in (
            ("null", False, False, "native"),
            ("fetch", True, False, "native"),
            ("null_compact", False, True, "native"),
            ("fetch_compact", True, True, "native"),
            ("null_raw", False, False, "raw"),
            ("fetch_raw", True, False, "raw")):
        n = cycle(fetch, compact, parser)     # warmup incl. compile
        t0 = time.perf_counter()
        n = cycle(fetch, compact, parser)
        dt = time.perf_counter() - t0
        xrt = batch * n * 6 * 256 / 48000.0 / dt
        log(f"config2 e2e bytes->PCM [{mode} sink]: {batch} lanes x {n} "
            f"frames in {dt * 1000:.0f} ms -> {xrt:.0f}x realtime")
        out[mode] = round(xrt, 1)
    # auditable transfer accounting (stereo premix, P=2 planes):
    # f32 planes vs block-float mantissas + per-16-bin-group scales vs
    # raw coded bytes + side-info meta (no deltba; measured dtype sum)
    P_pl = 2
    out["h2d_bytes_per_frame_f32"] = 6 * (P_pl * 256 * 4 + 5 + 4)
    out["h2d_bytes_per_frame_compact"] = 6 * (P_pl * 256 * 2
                                              + P_pl * 16 * 4 + 5 + 4)
    from ac3acm_tpu.host.native import RAW_REC_DTYPE
    meta_bytes = sum(
        int(np.dtype(dt).itemsize) * int(np.prod(shp, dtype=int))
        for _, (dt, shp) in (
            (n, RAW_REC_DTYPE.fields[n][0].subdtype
             or (RAW_REC_DTYPE.fields[n][0], ()))
            for n in RAW_REC_DTYPE.names if n != "deltba"))
    es_frame = -(-len(base[0]) // 128) * 128
    out["h2d_bytes_per_frame_raw"] = es_frame + 6 * (meta_bytes + 4)
    return out


def bench_hetero(batch, chunk_frames=8, nchunks=3):
    """Mixed-format batch: 50% 5.1->2.0 lanes + 50% 2.0 lanes, through the
    bucketed heterogeneous dispatch (VERDICT r2 #7).  Reported next to the
    homogeneous halves so the bucket-sum claim is auditable: mixed cost
    should approximate the sum of the two buckets' costs, not
    formats x full-batch."""
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.parallel.pipeline import BatchedDecoder
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    total = chunk_frames * nchunks
    es51 = golden_es()
    es20 = golden_es("stereo_192.ac3")
    fr51 = frames_of(es51, total + 2)
    fr20 = frames_of(es20, total + 2)

    def feed_fn(kind):
        def lanes(i):
            base = fr51 if kind[i] else fr20
            rot = i % 8
            return b"".join(base[rot:] + base[:rot])
        return lanes

    def cycle(kind):
        dec = BatchedDecoder(batch, flags, bias=384.0, emit_int16=True,
                             parser="native")
        lanes = feed_fn(kind)
        for i in range(batch):
            dec.feed(i, lanes(i))
        nfr = 0
        for _ in range(nchunks):
            r = dec.decode_available(max_frames=chunk_frames)
            if r is None:
                break
            nfr += r[1].shape[1]
            _ = np.asarray(r[0][:, -1, :, -1])      # consume (small fetch)
        return nfr

    out = {}
    for name, kind in (("all_51", [True] * batch),
                       ("all_20", [False] * batch),
                       ("mixed", [i % 2 == 0 for i in range(batch)])):
        n = cycle(kind)                              # warmup incl. compile
        t0 = time.perf_counter()
        n = cycle(kind)
        dt = time.perf_counter() - t0
        xrt = batch * n * 6 * 256 / 48000.0 / dt
        log(f"hetero [{name}]: {batch} lanes x {n} frames in "
            f"{dt * 1000:.0f} ms -> {xrt:.0f}x realtime")
        out[name] = round(xrt, 1)
    return out


def bench_config2_raw_device(batch, nframes):
    """Raw-H2D capability: bitstream unpack ON DEVICE.  Frame bytes +
    side-info meta staged in device memory; exponent decode, bit
    allocation, mantissa dequant (bitfield gathers) and the decode
    pipeline all run on the device -- the host contribution is only the
    side-info parse (see e2e_sideinfo_parse_xrt_per_core)."""
    import jax
    import jax.numpy as jnp
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.host.native import SideinfoBatchParser
    from ac3acm_tpu.models.decoder import StreamFormat, steady_ok
    from ac3acm_tpu.ops.unpack_device import (init_unpack_carry,
                                              prune_raw_meta,
                                              static_cpl_fc)
    from ac3acm_tpu.parallel.pipeline import (init_batched_carry,
                                              raw_batched_pipeline)
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    sp = SideinfoBatchParser(1, nthreads=1)
    r = sp.parse([golden_es() * ((nframes // 8) + 1)], nframes, flags,
                 1.0, 384.0)
    assert int(r["nframes"][0]) == nframes and r["valid"][0].all()
    mb = max(-(-int(r["fsizes"][0].max()) // 128) * 128, 128)
    fu8_1 = r["frames"][0, :, :mb]
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
        x = jnp.asarray(x)
        return jax.jit(
            lambda a: jnp.broadcast_to(a[None], (batch,) + a.shape)
            .copy())(x)

    fu8 = bcast(fu8_1)
    meta = {k: bcast(v) for k, v in meta1.items()}
    bias = jnp.full((batch, 6 * nframes), 384.0, jnp.float32)
    from ac3acm_tpu.ops.unpack_device import (static_alloc_pts,
                                              static_exp_pts)
    fn = raw_batched_pipeline(fmt, emit_int16=True, steady=steady,
                              long_only=lo, cpl_fc=static_cpl_fc(meta1),
                              exp_pts=static_exp_pts(meta1),
                              alloc_pts=static_alloc_pts(meta1))
    state = {"c": (init_unpack_carry(batch), init_batched_carry(batch))}

    def run():
        state["c"], pcm = fn(state["c"], fu8, meta, bias)
        jax.block_until_ready(pcm)

    dt, times = best_of(run, warmup=1, reps=5)
    xrt = batch * nframes * 6 * 256 / 48000.0 / dt
    log(f"config2 raw device (on-chip unpack): {batch} x {nframes}f, "
        f"best {dt * 1000:.1f} ms, {xrt:.0f}x realtime")
    return round(xrt, 1)


def bench_sideinfo_parse():
    """Side-info-only host parse rate per core (the raw-H2D host bound)."""
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.host.native import SideinfoBatchParser
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    big = golden_es() * 16
    L, F = 8, 12
    SideinfoBatchParser(L, nthreads=1).parse([big] * L, F, flags, 1.0,
                                             384.0)
    d2 = SideinfoBatchParser(L, nthreads=1)
    t0 = time.perf_counter()
    reps = 6
    for _ in range(reps):
        d2.parse([big] * L, F, flags, 1.0, 384.0)
    dt = time.perf_counter() - t0
    xrt = (L * F * reps * 0.032) / dt
    us_frame = dt / (L * F * reps) * 1e6
    log(f"host side-info parse: {us_frame:.1f} us/frame "
        f"({xrt:.0f}x realtime/core)")
    return round(xrt, 1), round(us_frame, 2)


def bench_host_parse():
    """Host-side parse+premix throughput per core (the e2e bound)."""
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.host.native import DenseBatchParser
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    big = golden_es() * 16
    L, F = 8, 12
    d = DenseBatchParser(L, nthreads=1)
    d.parse([big] * L, F, flags, 1.0, 384.0, pre_planes=2)
    d2 = DenseBatchParser(L, nthreads=1)
    t0 = time.perf_counter()
    reps = 6
    for _ in range(reps):
        d2.parse([big] * L, F, flags, 1.0, 384.0, pre_planes=2)
    dt = time.perf_counter() - t0
    xrt = (L * F * reps * 0.032) / dt
    us_frame = dt / (L * F * reps) * 1e6
    log(f"host parse+premix: {us_frame:.1f} us/frame "
        f"({xrt:.0f}x realtime/core)")
    return round(xrt, 1), round(us_frame, 2)


# ---------------------------------------------------------------------------
# configs 3/4: batched encode (device + threaded host pack, all timed)
# ---------------------------------------------------------------------------

def _encode_pcm(channels: int, nframes: int):
    """Deterministic PCM content: decoded golden audio tiled per channel."""
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.host.native import NativeDecoder
    d = NativeDecoder()
    out = d.decode_stream(b"".join(frames_of(golden_es(), 16)),
                          T.A52_STEREO | T.A52_ADJUST_LEVEL, 1.0, 384.0)
    pcm = np.clip(np.round(out - 384.0) * 32768.0 / 2, -20000, 20000)
    flat = pcm.transpose(0, 2, 1).reshape(-1, 2)       # interleave blocks
    need = nframes * 1536
    reps = need // flat.shape[0] + 1
    flat = np.tile(flat, (reps, 1))[:need]
    chans = [flat[:, i % 2] * (1.0 - 0.05 * i) for i in range(channels)]
    return np.stack(chans, -1).astype(np.int16)


def bench_encode_device(batch, nframes, bitrate, channels, label):
    """Device-side encode throughput: inputs staged in device memory,
    encode+pack dispatch (encode_pipeline_packed) ending in
    block_until_ready on the finished frames.  This is the device
    capability number behind the e2e figures (which add host IO)."""
    import jax
    import jax.numpy as jnp
    from ac3acm_tpu.models.encoder import (encode_pipeline_packed,
                                           make_config)
    cfg = make_config(48000, bitrate * 1000, channels)
    pcm = _encode_pcm(channels, nframes)                 # [n, ch] int16
    frames = np.asarray(pcm, np.int16).reshape(nframes, 1536, channels)
    dev = jax.jit(lambda x: jnp.broadcast_to(
        x[:, None], (nframes, batch, 1536, channels)).copy())(
        jnp.asarray(frames))
    fn = encode_pipeline_packed(cfg)
    state = {"last": jnp.zeros((batch, channels, 256), jnp.int32),
             "csnr": jnp.full((batch,), 40, jnp.int32)}

    def run():
        (state["last"], state["csnr"]), ok, fr = fn(dev, state["last"],
                                                    state["csnr"])
        jax.block_until_ready(fr)
    dt, times = best_of(run, warmup=1, reps=5)
    xrt = batch * nframes * 1536 / 48000.0 / dt
    log(f"{label}: {batch} x {nframes}f, best {dt * 1000:.0f} ms "
        f"({[round(t * 1000) for t in times]}), {xrt:.0f}x realtime")
    return round(xrt, 1)


def bench_encode(batch, nframes, bitrate, channels, label):
    from ac3acm_tpu.parallel.encode import BatchedEncoder
    pcm = _encode_pcm(channels, nframes)
    pcm_b = np.broadcast_to(pcm, (batch,) + pcm.shape).copy()
    enc = BatchedEncoder(batch, 48000, bitrate * 1000, channels)

    def run():
        out = enc.encode_frames(pcm_b)
        assert len(out) == batch and len(out[0]) > 0
    dt, times = best_of(run, warmup=1, reps=3)
    xrt = batch * nframes * 1536 / 48000.0 / dt
    log(f"{label}: {batch} x {nframes}f, best {dt * 1000:.0f} ms "
        f"({[round(t * 1000) for t in times]}), {xrt:.0f}x realtime")
    return round(xrt, 1)


# ---------------------------------------------------------------------------
# config 5: transcode 5.1 448k -> 2.0 192k, bytes -> bytes
# ---------------------------------------------------------------------------

def bench_config5(batch, nframes, parser="native"):
    from ac3acm_tpu.parallel.transcode import Transcoder
    fb = frames_of(golden_es(), nframes)
    data = [b"".join(fb)] * batch
    # parser='native' ships compact block-float premixed planes (~6.5 KB/
    # frame H2D, SNR-parity gated); parser='raw' ships the coded ES bytes
    # themselves (~1.8 KB/frame) and unpacks the bitstream on device --
    # byte-identical output, gated by
    # tests/test_transcode.py::test_transcode_raw_parser_byte_identical
    tc = Transcoder(batch, 192000, 2, compact_h2d=parser == "native",
                    parser=parser)

    # warmup: compile every program in the chain
    out = tc.step_frames(data, nframes)
    assert len(out) == batch and out[0][:2] == b"\x0b\x77"

    # steady state: depth-2 dispatch/finish pipeline, so each chunk's host
    # parse and frame fetch overlap the previous chunk's link+device drain
    # (byte-identity of the pipelined form is gated by
    # tests/test_transcode.py::test_transcode_pipelined)
    nsteps = 6
    h = tc.dispatch_frames(data, nframes)
    t0 = time.perf_counter()
    for _ in range(nsteps):
        nxt = tc.dispatch_frames(data, nframes)
        out = tc.finish(h)
        h = nxt
    dt = (time.perf_counter() - t0) / nsteps
    _ = tc.finish(h)
    assert len(out) == batch and out[0][:2] == b"\x0b\x77"
    xrt = batch * nframes * 1536 / 48000.0 / dt
    log(f"config5 transcode bytes->bytes [{parser}]: {batch} x {nframes}f, "
        f"{dt * 1000:.0f} ms/chunk pipelined, {xrt:.0f}x realtime")
    return round(xrt, 1)


def main():
    import jax
    enable_compile_cache()
    dev0 = jax.devices()[0]
    device = {"platform": dev0.platform, "kind": dev0.device_kind,
              "count": len(jax.devices())}

    batch = int(os.environ.get("BENCH_BATCH", "4096"))
    nframes = int(os.environ.get("BENCH_FRAMES", "64"))
    e2e_batch = int(os.environ.get("BENCH_E2E_BATCH", "256"))
    which = os.environ.get("BENCH_CONFIGS",
                           "1,2,e2e,3,4,5,hetero").split(",")
    if len(sys.argv) > 1 and sys.argv[1] == "--e2e":
        which = ["e2e"]

    configs = {}
    errors = {}

    def run_cfg(name, fn):
        """Per-config fault isolation: one config's failure is recorded
        in the JSON instead of erasing every other config's result (the
        exit code still reports it)."""
        try:
            fn()
        except Exception as e:
            import traceback
            traceback.print_exc(file=sys.stderr)
            errors[name] = f"{type(e).__name__}: {e}"
            log(f"CONFIG {name} FAILED: {e}")

    def cfg1():
        c1, c1_ref = bench_config1()
        configs["c1_single_stream_cpu_xrt"] = c1
        if c1_ref:
            configs["c1_reference_liba52_same_host_xrt"] = c1_ref

    def cfg2():
        xrt, fps = bench_config2_device(batch, nframes)
        configs["c2_batched_decode_device_xrt"] = xrt
        configs["c2_accuracy_mode"] = "reference (bit-exact, compare.c " \
                                      "by construction)"

    def cfg2_fast():
        xrt, fps = bench_config2_device(batch, nframes, fast=True)
        configs["c2_fast_device_xrt"] = xrt
        configs["c2_fast_accuracy_mode"] = "fast (opt-in; max<=0.02 " \
                                           "mean<=0.001 sigma<=0.002)"

    def cfg2_raw():
        configs["c2_raw_device_xrt"] = bench_config2_raw_device(
            int(os.environ.get("BENCH_RAW_BATCH", "256")), 16)

    def cfg_e2e():
        h2d_mbps, d2h_mbps = bench_link()
        configs["link_h2d_mbps"] = h2d_mbps
        configs["link_d2h_mbps"] = d2h_mbps
        e2e = bench_config2_e2e(e2e_batch, 24)
        configs["c2_e2e_bytes_to_pcm_null_sink_xrt"] = e2e["null"]
        configs["c2_e2e_bytes_to_pcm_fetch_xrt"] = e2e["fetch"]
        configs["c2_e2e_compact_null_sink_xrt"] = e2e["null_compact"]
        configs["c2_e2e_compact_fetch_xrt"] = e2e["fetch_compact"]
        configs["c2_e2e_raw_null_sink_xrt"] = e2e["null_raw"]
        configs["c2_e2e_raw_fetch_xrt"] = e2e["fetch_raw"]
        configs["h2d_bytes_per_frame_f32"] = e2e["h2d_bytes_per_frame_f32"]
        configs["h2d_bytes_per_frame_compact"] = \
            e2e["h2d_bytes_per_frame_compact"]
        configs["h2d_bytes_per_frame_raw"] = e2e["h2d_bytes_per_frame_raw"]

    def cfg_host_parse():
        parse_xrt, parse_us = bench_host_parse()
        configs["e2e_host_parse_xrt_per_core"] = parse_xrt
        configs["host_us_per_frame"] = parse_us
        si_xrt, si_us = bench_sideinfo_parse()
        configs["e2e_sideinfo_parse_xrt_per_core"] = si_xrt
        configs["sideinfo_us_per_frame"] = si_us
        configs["host_cores"] = os.cpu_count()

    def cfg3():
        configs["c3_stereo_encode_192k_xrt"] = \
            bench_encode(256, 16, 192, 2, "config3 stereo encode")

    def cfg3_dev():
        configs["c3_device_xrt"] = bench_encode_device(
            1024, 8, 192, 2, "config3 device-side stereo encode")

    def cfg4():
        configs["c4_51_encode_640k_xrt"] = \
            bench_encode(256, 8, 640, 6, "config4 5.1 encode")

    def cfg4_dev():
        configs["c4_device_xrt"] = bench_encode_device(
            512, 8, 640, 6, "config4 device-side 5.1 encode")

    def cfg5():
        configs["c5_transcode_1024_xrt"] = bench_config5(1024, 4)

    def cfg5_raw():
        configs["c5_transcode_raw_xrt"] = bench_config5(
            int(os.environ.get("BENCH_RAW_TC_BATCH", "1024")), 4,
            parser="raw")

    def cfg_hetero():
        het = bench_hetero(int(os.environ.get("BENCH_HETERO_BATCH", "256")))
        configs["hetero_all_51_xrt"] = het["all_51"]
        configs["hetero_all_20_xrt"] = het["all_20"]
        configs["hetero_mixed_50_50_xrt"] = het["mixed"]
        # overhead of per-format bucketing: a perfectly-bucketed mixed
        # batch costs the half-and-half time-sum of the uniform configs
        # (harmonic mean of their xrt); anything above that is repo-owned
        # re-bucketing/marshaling (VERDICT r4 #5 normalizer)
        pred = 2.0 / (1.0 / het["all_51"] + 1.0 / het["all_20"])
        configs["hetero_bucketing_overhead_pct"] = round(
            (pred / het["mixed"] - 1.0) * 100.0, 1)

    if "1" in which:
        run_cfg("c1", cfg1)
    if "2" in which:
        run_cfg("c2_device", cfg2)
        run_cfg("c2_fast_device", cfg2_fast)
        run_cfg("c2_raw_device", cfg2_raw)
    if "e2e" in which:
        run_cfg("e2e", cfg_e2e)
        run_cfg("host_parse", cfg_host_parse)
    if "3" in which:
        run_cfg("c3", cfg3)
        run_cfg("c3_device", cfg3_dev)
    if "4" in which:
        run_cfg("c4", cfg4)
        run_cfg("c4_device", cfg4_dev)
    if "5" in which:
        run_cfg("c5", cfg5)
        run_cfg("c5_raw", cfg5_raw)
    if "hetero" in which:
        run_cfg("hetero", cfg_hetero)

    if errors:
        configs["errors"] = errors
    headline = configs.get("c2_batched_decode_device_xrt")
    if headline is None:
        headline = next((v for v in configs.values()
                         if isinstance(v, (int, float))), 0.0)
    print(json.dumps({
        "metric": "batched 5.1->2.0 decode realtime factor per device "
                  "(device pipeline)",
        "value": headline,
        "unit": "x_realtime",
        "device": device,
        "configs": configs,
    }))
    if errors:
        log(f"bench completed with {len(errors)} failed config(s): "
            f"{sorted(errors)}")
        sys.exit(1)


if __name__ == "__main__":
    main()
