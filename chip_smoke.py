"""Bring-up check: the codec's main paths on a GPU, in one process.

    python chip_smoke.py                # one card, the phases below
    python chip_smoke.py --four-cards   # 4-card data mesh vs card 0 alone

One card, in this order:
  1. device report (platform, device kind, count, FMA-contraction probe);
  2. decode: BatchedDecoder(parser="native", emit_int16=True) on the
     committed 5.1/448 kbps stream, 4096 lanes, 16-frame chunks, 3 chunks,
     default order-exact (ACCURACY="reference") filterbank;
  3. raw-H2D decode: the same lanes through parser="raw" (bitstream unpack
     on the device), bit-identical to phase 2;
  4. golden regression: every committed golden stream through the default
     Decoder, held to the reference's compare.c bounds;
  5. device encode: BatchedEncoder frames byte-identical to committed
     reference-encoded streams;
  6. transcode: Transcoder(1024, 192000, 2) re-encodes 5.1/448 to
     2.0/192 through dispatch_frames/finish with on-device packing,
     byte-identical to the reference chain (bit-exact C++ decode, int16
     conversion, device encoder).

With --four-cards only decode, raw-H2D decode and transcode run, over 4096
lanes on a 4x1 ("data", "model") mesh, each compared bitwise with the same
lanes on device 0 alone.

Each phase prints its wall time and the XLA compile time spent in it.  Any
failed check raises, so the script exits non-zero; it exits non-zero
without a result when JAX finds no GPU.  The last line is one JSON object:
{"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
BENCH = "bench_51_448.ac3"
# test/compare.c:70-72 thresholds, in 1/32768 full-scale units
COMPARE_C = (0.01, 0.001, 0.001)
# committed reference-encoded streams the encode phase reproduces
ENCODE_STREAMS = ("bench_51_448.ac3", "stereo_192.ac3", "mono_96.ac3")

_COMPILE_S = [0.0]


def _on_duration(event, duration, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        _COMPILE_S[0] += duration


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    """`nvidia-smi` name and power limit, from a child that never touches
    JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip()


def require_gpu():
    """The device report, or SystemExit when JAX runs on anything but a
    GPU: this check never falls back to the CPU."""
    import jax
    platform = jax.default_backend()
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (backend "
                         f"{platform!r}); nothing was run")
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def run_phase(name, fn, *args, **kw):
    c0, t0 = _COMPILE_S[0], time.perf_counter()
    out = fn(*args, **kw)
    log(f"[{name}] wall_s {time.perf_counter() - t0:.3f}")
    log(f"[{name}] compile_s {_COMPILE_S[0] - c0:.3f}")
    return out


def golden_es(name=BENCH) -> bytes:
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def frames_of(es: bytes) -> list[bytes]:
    from ac3acm_tpu.io.demux import es_frames
    return [f for f, _, _ in es_frames(es)]


def lane_streams(lanes: int, nframes: int) -> list[bytes]:
    """Per-lane byte streams of `nframes` frames of the committed 5.1
    stream, lane i starting at frame i % 8 (eight distinct contents, so
    a lane mix-up shows) plus one spare frame for the frame sync."""
    base = frames_of(golden_es())
    n = len(base)
    out = []
    for r in range(min(lanes, n)):
        out.append(b"".join(base[(r + k) % n] for k in range(nframes + 1)))
    return [out[i % n] for i in range(lanes)]


def to_int16(biased):
    """Biased (+384) float PCM -> int16: the reference's bias-trick
    conversion (ops.filterbank.convert_to_int16, io.sinks.convert_s16)."""
    x = (np.asarray(biased, np.float64) - 384.0) * 32768.0
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def compare_c(mine, ref):
    """compare.c max / |mean| / sigma of mine - ref, 1/32768 units."""
    from tests.oracle import compare_oracle
    return compare_oracle(np.asarray(mine, np.float64) / 32768.0,
                          np.asarray(ref, np.float64) / 32768.0)


def decode_lanes(lanes: int, chunk: int, nchunks: int, parser: str,
                 mesh=None):
    """Decode lane_streams(lanes) in `nchunks` chunks of `chunk` frames.
    Returns (pcm [lanes, nchunks*chunk*6, 2, 256] int16 on the host,
    per-chunk seconds, the decoder)."""
    import jax
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.parallel.pipeline import BatchedDecoder
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    dec = BatchedDecoder(lanes, flags, bias=384.0, emit_int16=True,
                         parser=parser, mesh=mesh)
    for i, s in enumerate(lane_streams(lanes, chunk * nchunks)):
        dec.feed(i, s)
    pcms, secs = [], []
    for _ in range(nchunks):
        t0 = time.perf_counter()
        r = dec.decode_available(max_frames=chunk)
        assert r is not None, "decoder produced no chunk"
        pcm, valid = r
        jax.block_until_ready(pcm)
        secs.append(time.perf_counter() - t0)
        assert np.asarray(valid).all(), "a lane-frame was flagged invalid"
        assert pcm.shape == (lanes, 6 * chunk, 2, 256), pcm.shape
        assert pcm.dtype == np.int16, pcm.dtype
        pcms.append(np.asarray(pcm))
    return np.concatenate(pcms, axis=1), secs, dec


def check_decode_pcm(pcm):
    """Lanes with equal content must agree bitwise, and every lane that
    starts at frame 0 must reproduce the committed reference oracle over
    the 8 frames it covers (int16 of the reference float output)."""
    oracle = np.load(os.path.join(GOLDEN, BENCH + ".stereo_float.npy"))
    want = to_int16(oracle.astype(np.float32)
                    + np.float32(384.0)).reshape(-1, 2, 256)
    n = min(want.shape[0], pcm.shape[1])
    lanes = pcm.shape[0]
    for r in range(min(lanes, 8)):
        assert (pcm[r::8] == pcm[r]).all(), f"lanes of rotation {r} differ"
    maxe, mean, std = compare_c(pcm[0, :n], want[:n])
    exact = bool((pcm[0, :n] == want[:n]).all())
    log(f"decode vs golden oracle ({n // 6} frames): max {maxe:.6f} "
        f"mean {mean:.6f} sigma {std:.6f} (1/32768 units), "
        f"bit-exact {exact}")
    assert (maxe <= COMPARE_C[0] and mean <= COMPARE_C[1]
            and std <= COMPARE_C[2]), (maxe, mean, std)
    return maxe, mean, std


def decode_step_memory(dec, lanes: int, chunk: int):
    """compiled.memory_analysis() of the decode step the dispatch ran
    (the premixed steady 5.1->2.0 body)."""
    import jax
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.host.native import NativeParser
    from ac3acm_tpu.parallel.pipeline import batched_pipeline
    blocks, _ = NativeParser().decode_frames(
        golden_es(), 8, T.A52_STEREO | T.A52_ADJUST_LEVEL, 1.0, 384.0)
    long_only = not np.asarray(blocks["blksw"]).any()
    fmt = dec._fmt
    fn = batched_pipeline(fmt, None, True, steady=True, long_only=long_only,
                          premixed=True)
    S = 6 * chunk
    sds = jax.ShapeDtypeStruct
    carry = (sds((lanes, 6, 128), np.float32), sds((lanes,), np.bool_))
    blk = {"freq": sds((lanes, S, fmt.nch_out, 256), np.float32),
           "blksw": sds((lanes, S, 5), np.bool_),
           "bias": sds((lanes, S), np.float32)}
    return fn.lower(carry, blk).compile().memory_analysis()


def phase_decode(lanes=4096, chunk=16, nchunks=3):
    import jax
    from ac3acm_tpu.ops.imdct_exact import backend_contracts_fma
    log(f"FMA-contraction probe ({jax.default_backend()}): "
        f"{backend_contracts_fma(jax.default_backend())}")
    pcm, secs, dec = decode_lanes(lanes, chunk, nchunks, "native")
    log(f"decode chunk seconds ({lanes} lanes x {chunk} frames): "
        f"{[round(s, 4) for s in secs]}")
    check_decode_pcm(pcm)
    log(f"decode step memory_analysis: "
        f"{decode_step_memory(dec, lanes, chunk)}")
    return pcm


def phase_raw(native_pcm, chunk=16, nchunks=3):
    lanes = native_pcm.shape[0]
    pcm, secs, _ = decode_lanes(lanes, chunk, nchunks, "raw")
    log(f"raw-H2D chunk seconds ({lanes} lanes x {chunk} frames): "
        f"{[round(s, 4) for s in secs]}")
    same = bool(np.array_equal(pcm, native_pcm))
    log(f"raw-H2D PCM bit-identical to native: {same}")
    assert same, "raw-H2D PCM differs from the native path"


def phase_golden():
    """Every committed golden stream through the default Decoder, held
    to compare.c (tests/test_regression.py's rule: overdriven streams
    scale the bound with their peak)."""
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.models.decoder import Decoder
    from tests.oracle import compare_oracle
    names = sorted(f for f in os.listdir(GOLDEN) if f.endswith(".ac3"))
    for name in names:
        ref = np.load(os.path.join(GOLDEN, name + ".stereo_float.npy"))
        out, fmt = Decoder().decode_stream(
            golden_es(name), T.A52_STEREO | T.A52_ADJUST_LEVEL,
            level=1.0, bias=0.0)
        assert fmt.nch_out == 2
        mine = out.reshape(out.shape[0], -1)
        maxe, mean, std = compare_oracle(mine, ref)
        tol = max(COMPARE_C[0], 1e-6 * max(np.abs(ref).max(), 1.0) * 32768)
        exact = bool(np.array_equal(mine, ref))
        log(f"golden {name}: max {maxe:.6f} mean {mean:.6f} "
            f"sigma {std:.6f} bound {tol:.4f} bit-exact {exact}")
        assert maxe <= tol and mean <= tol / 10 and std <= tol / 5, \
            (name, maxe, mean, std, tol)
    return len(names)


def phase_encode(names=ENCODE_STREAMS, lanes=8):
    """BatchedEncoder (device encode + on-device pack) frames must equal
    the committed reference-encoded streams byte for byte."""
    from ac3acm_tpu.parallel.encode import BatchedEncoder
    from tests.oracle import ENC_SPECS, enc_spec_pcm
    specs = {s[0]: s for s in ENC_SPECS}
    for name in names:
        spec = specs[name]
        _, nch, kbps, freq = spec[:4]
        pcm = enc_spec_pcm(spec)
        out = BatchedEncoder(lanes, freq, kbps * 1000, nch).encode_frames(
            np.broadcast_to(pcm, (lanes,) + pcm.shape).copy())
        ok = all(o == golden_es(name) for o in out)
        log(f"encode {name} ({lanes} lanes): byte-identical {ok}")
        assert ok, f"device encoder differs from committed {name}"


def transcode_lanes(lanes: int, chunk: int, nchunks: int, mesh=None):
    """Transcoder(lanes, 192000, 2) over lane_streams, depth-2
    dispatch_frames/finish pipeline.  Returns (bytes per lane, per-chunk
    seconds in the steady loop)."""
    from ac3acm_tpu.parallel.transcode import Transcoder
    streams = lane_streams(lanes, chunk * nchunks)
    fr = {i: frames_of(streams[i]) for i in range(min(lanes, 8))}
    data = [[b"".join(fr[i % 8][c * chunk:(c + 1) * chunk])
             for i in range(lanes)] for c in range(nchunks)]
    tc = Transcoder(lanes, 192000, 2, mesh=mesh)
    out = [b""] * lanes
    secs = []
    h = tc.dispatch_frames(data[0], chunk)
    for c in range(1, nchunks + 1):
        t0 = time.perf_counter()
        nxt = tc.dispatch_frames(data[c], chunk) if c < nchunks else None
        got = tc.finish(h)
        secs.append(time.perf_counter() - t0)
        out = [o + g for o, g in zip(out, got)]
        h = nxt
    return out, secs


def transcode_oracle(lanes: int, chunk: int, nchunks: int):
    """The reference transcode chain for lane_streams: the bit-exact C++
    decoder (host.native.NativeDecoder, float-for-float liba52), the
    reference int16 conversion, then the device encoder + packer
    (byte-identical to the reference encoder, phase 5), chunk by chunk
    with carried state."""
    import jax.numpy as jnp
    import ac3acm_tpu.tables as T
    from ac3acm_tpu.host.native import NativeDecoder
    from ac3acm_tpu.models.encoder import encode_pipeline_packed, make_config
    cfg = make_config(48000, 192000, 2)
    streams = lane_streams(min(lanes, 8), chunk * nchunks)
    pcm = []
    for s in streams:
        planes = NativeDecoder().decode_stream(
            s, T.A52_STEREO | T.A52_ADJUST_LEVEL, 1.0, 384.0)
        i16 = to_int16(planes[: 6 * chunk * nchunks])     # [nblk, 2, 256]
        pcm.append(i16.transpose(0, 2, 1).reshape(-1, 1536, 2))
    pcm = np.stack([pcm[i % 8] for i in range(lanes)])    # [L, F, 1536, 2]
    fn = encode_pipeline_packed(cfg)
    last = jnp.zeros((lanes, 2, 256), jnp.int32)
    csnr = jnp.full((lanes,), 40, jnp.int32)
    out = [b""] * lanes
    for c in range(nchunks):
        x = np.moveaxis(pcm[:, c * chunk:(c + 1) * chunk], 1, 0)
        (last, csnr), ok, fr = fn(jnp.asarray(x.astype(np.int32)), last,
                                  csnr)
        assert np.asarray(ok).all()
        fr = np.asarray(fr)
        out = [o + fr[:, i].tobytes() for i, o in enumerate(out)]
    return out


def phase_transcode(lanes=1024, chunk=16, nchunks=3):
    from ac3acm_tpu.host.parse import syncinfo
    out, secs = transcode_lanes(lanes, chunk, nchunks)
    log(f"transcode chunk seconds ({lanes} lanes x {chunk} frames, "
        f"pipelined): {[round(s, 4) for s in secs]}")
    nfr = chunk * nchunks
    for i in range(min(lanes, 8)):
        s = out[i]
        assert len(s) == nfr * 768, (i, len(s))
        for f in range(nfr):
            size = syncinfo(s[f * 768: f * 768 + 7])[0]
            assert size == 768, (i, f, size)
        assert all(out[j] == s for j in range(i, lanes, 8)), i
    # the oracle encodes at the transcode's own shapes, so it reuses the
    # compiled encode+pack program
    want = transcode_oracle(lanes, chunk, nchunks)
    same = out == want
    log(f"transcode: {lanes} lanes x {nfr} frames of 2.0/192 kbps, "
        f"byte-identical to the reference chain: {same}")
    assert same, "transcode differs from decode -> int16 -> encode"


def four_cards(lanes=4096, chunk=16, nchunks=3):
    """Decode, raw-H2D decode and transcode over a 4x1 data mesh, each
    bitwise equal to the same lanes on device 0 alone."""
    import jax
    from ac3acm_tpu.parallel.mesh import make_mesh
    devs = jax.devices()
    assert len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}"
    mesh = make_mesh(data=4, model=1, devices=devs[:4])
    for parser in ("native", "raw"):
        one, _, _ = decode_lanes(lanes, chunk, nchunks, parser)
        c0, t0 = _COMPILE_S[0], time.perf_counter()
        four, secs, _ = decode_lanes(lanes, chunk, nchunks, parser,
                                     mesh=mesh)
        log(f"[mesh {parser}] wall_s {time.perf_counter() - t0:.3f} "
            f"compile_s {_COMPILE_S[0] - c0:.3f} chunk seconds "
            f"{[round(s, 4) for s in secs]}")
        same = bool(np.array_equal(one, four))
        log(f"4-card {parser} decode bitwise equal to device 0: {same}")
        assert same, parser
        check_decode_pcm(one)
    one, _ = transcode_lanes(lanes, chunk, nchunks)
    c0, t0 = _COMPILE_S[0], time.perf_counter()
    four, secs = transcode_lanes(lanes, chunk, nchunks, mesh=mesh)
    log(f"[mesh transcode] wall_s {time.perf_counter() - t0:.3f} "
        f"compile_s {_COMPILE_S[0] - c0:.3f} chunk seconds "
        f"{[round(s, 4) for s in secs]}")
    same = one == four
    log(f"4-card transcode bitwise equal to device 0: {same}")
    assert same, "transcode"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card data-mesh phases")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import jax
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    device = require_gpu()
    from ac3acm_tpu.utils.cache import enable_compile_cache
    log(f"compile cache: {enable_compile_cache('gpu')}")
    log(card_line())
    log(f"device report: {device} jax {jax.__version__}")
    dev0 = jax.devices()[0]

    if args.four_cards:
        run_phase("four_cards", four_cards)
    else:
        pcm = run_phase("decode", phase_decode)
        run_phase("raw_h2d", phase_raw, pcm)
        del pcm
        run_phase("golden", phase_golden)
        run_phase("encode", phase_encode)
        run_phase("transcode", phase_transcode)
    stats = dev0.memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
