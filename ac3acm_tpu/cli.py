"""Command-line tools: decode (a52dec parity), encode, extract, info.

    python -m ac3acm_tpu.cli decode in.ac3 -o out.wav --output wav
    python -m ac3acm_tpu.cli decode in.vob --container ps --track 0 ...
    python -m ac3acm_tpu.cli encode in.wav -o out.ac3 -b 192
    python -m ac3acm_tpu.cli extract in.ts --pid 0x1100 -o out.ac3
    python -m ac3acm_tpu.cli info in.ac3

Flag parity with the reference CLI (a52dec.c:130-230): gain (-g, in 6dB
steps there; dB here), driver selection (-o), track/pid selection for
PS/TS input, DRC toggle.
"""
from __future__ import annotations

import argparse
import struct
import sys

import numpy as np

from . import tables as T
from .io import demux
from .host import pack as PK
from .io.sinks import make_sink
from .utils.config import CodecConfig
from .utils.meter import FpsMeter


def _open_out(path):
    return sys.stdout.buffer if path in (None, "-") else open(path, "wb")


def _stream_frames(fin, kind, track, pid, chunk=4096):
    """Bounded-memory frame source: 4 KB reads -> (optional) resumable
    PS/TS demux -> frame-sync scan with byte-wise resync.  Mirrors the
    reference CLI's es_loop/ps_loop/ts_loop (a52dec.c:590,543,564 read
    fixed-size chunks and carry sync state across reads); memory use is
    bounded by the compaction below regardless of stream length.

    Yields (frame_bytes, stream_flags, sample_rate).
    """
    from .host.parse import syncinfo
    first = fin.read(chunk)
    if kind == "auto":
        if first[:1] == b"\x47":
            kind = "ts"
        elif first[:4] == b"\x00\x00\x01\xba":
            kind = "ps"
        else:
            kind = "es"
    dm = (demux.PsDemux(track) if kind == "ps"
          else demux.TsDemux(pid) if kind == "ts" else None)
    buf = bytearray()
    pos = 0
    data = first
    while data:
        buf += dm.feed(data) if dm else data
        while True:
            size = 0
            while pos + 7 <= len(buf):
                size, fl, sr, _ = syncinfo(bytes(buf[pos:pos + 7]))
                if size:
                    break
                pos += 1                     # byte-wise resync
            if not size or pos + size > len(buf):
                break
            yield bytes(buf[pos:pos + size]), fl, sr
            pos += size
        if pos > (1 << 16):
            del buf[:pos]
            pos = 0
        data = fin.read(chunk)


def cmd_decode(args):
    import itertools
    if getattr(args, "accuracy", "reference") != "reference":
        from .models.decoder import set_accuracy
        set_accuracy(args.accuracy)
    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    frames = _stream_frames(fin, args.container, args.track, args.pid)
    try:
        first = next(frames)
    except StopIteration:
        print("no AC-3 frames found", file=sys.stderr)
        return 1
    frames = itertools.chain([first], frames)
    srate = first[2]
    fp = _open_out(args.out)
    sink = make_sink(args.output, fp)
    flags, level, bias = sink.setup(srate)
    flags |= T.A52_ADJUST_LEVEL
    level *= 2.0 ** (args.gain / 6.0)

    meter = FpsMeter(srate, enabled=not args.quiet)
    if args.sample_type != "float":
        # LIBA52_FIXED / LIBA52_DOUBLE arithmetic (SampleDecoder); fixed
        # decodes at level 1<<26 / bias 0 like the reference CLI built with
        # -DLIBA52_FIXED (audio_out_internal.h:30-32) and converts Q30 to
        # the sink's float domain afterwards
        from .host.native import SampleDecoder
        backend = args.backend if args.sample_type == "fixed" else "native"
        dec = SampleDecoder(args.sample_type, backend=backend)
        if not args.drc:
            dec.set_drc_enabled(False)
        fixed = args.sample_type == "fixed"
        lv = float(int((1 << 26) * level)) if fixed else level
        bs = 0.0 if fixed else bias
        for fb, fl, _ in frames:
            out = dec.decode_stream(fb, flags, lv, bs)
            if fixed:
                out = out.astype(np.float64) * 2.0 ** -30 + bias
            for blk in out:
                sink.play(_native_outmode(fl, flags), blk.astype(np.float32))
            meter.tick(1)
    elif args.backend == "native":
        # bit-exact C++ backend; low-latency single-stream path
        from .host.native import NativeDecoder
        dec = NativeDecoder()
        if not args.drc:
            dec.set_drc_enabled(False)
        for fb, fl, _ in frames:
            out = dec.decode_stream(fb, flags, level, bias)
            for blk in out:
                sink.play(_native_outmode(fl, flags), blk)
            meter.tick(1)
    else:
        from .models.decoder import Decoder
        dec = Decoder()
        if not args.drc:
            dec.set_drc_enabled(False)
        chunk = max(1, args.chunk_frames)
        while True:
            batch = [fb for fb, _, _ in itertools.islice(frames, chunk)]
            if not batch:
                break
            pcm, fmt = dec.decode_frames(batch, flags, level, bias)
            for blk in pcm:
                sink.play(fmt.output, blk)
            meter.tick(len(batch))
    meter.close()
    sink.close()
    if fp is not sys.stdout.buffer:
        fp.close()
    if fin is not sys.stdin.buffer:
        fin.close()
    return 0


def _native_outmode(coded_flags: int, req_flags: int) -> int:
    """Negotiated output mode for sink channel ordering."""
    from .host.parse import downmix_init
    out, _ = downmix_init(coded_flags & 7, req_flags, 1.0,
                          np.float32(0.5), np.float32(0.5))
    if (coded_flags & T.A52_LFE) and (req_flags & T.A52_LFE):
        out |= T.A52_LFE
    return out


def _read_wav(path):
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE", "not a RIFF/WAVE"
    pos = 12
    fmt = None
    pcm = None
    rate = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        sz = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + sz]
        if cid == b"fmt ":
            tag, nch, rate, _, _, bits = struct.unpack("<HHIIHH", body[:16])
            assert bits == 16, "only 16-bit PCM input supported"
            fmt = (nch, rate)
        elif cid == b"data":
            pcm = np.frombuffer(body, "<i2")
        pos += 8 + sz + (sz & 1)
    assert fmt and pcm is not None, "missing fmt/data chunk"
    nch, rate = fmt
    return pcm.reshape(-1, nch), rate


def cmd_encode(args):
    from .models.encoder import Encoder
    if args.input.endswith(".wav"):
        pcm, rate = _read_wav(args.input)
    else:
        raw = np.fromfile(args.input, "<i2")
        pcm = raw.reshape(-1, args.channels)
        rate = args.rate
    nch = pcm.shape[1]
    bitrate = (args.bitrate * 1000 if args.bitrate
               else CodecConfig.load().default_bitrate(nch))
    enc = Encoder(rate, bitrate, nch)
    fp = _open_out(args.out)
    meter = FpsMeter(rate, enabled=not args.quiet)
    nfr = pcm.shape[0] // T.FRAME_SAMPLES
    step = enc.CHUNK
    for i in range(0, nfr, step):
        f = min(step, nfr - i)
        fp.write(enc.encode(pcm[i * 1536:(i + f) * 1536]))
        meter.tick(f)
    meter.close()
    if fp is not sys.stdout.buffer:
        fp.close()
    print(f"encoded {nfr} frames @ {bitrate // 1000} kbps", file=sys.stderr)
    return 0


def cmd_extract(args):
    """Container -> raw AC-3 ES, streamed in 4 KB chunks (extract_a52
    parity: the reference demuxer is a resumable state machine fed from
    fixed-size reads, extract_a52.c)."""
    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    first = fin.read(4096)
    kind = args.container
    if kind == "auto":
        if first[:1] == b"\x47":
            kind = "ts"
        elif first[:4] == b"\x00\x00\x01\xba":
            kind = "ps"
        else:
            kind = "es"
    dm = (demux.PsDemux(args.track) if kind == "ps"
          else demux.TsDemux(args.pid) if kind == "ts" else None)
    fp = _open_out(args.out)
    data = first
    while data:
        fp.write(dm.feed(data) if dm else data)
        data = fin.read(4096)
    if fp is not sys.stdout.buffer:
        fp.close()
    if fin is not sys.stdin.buffer:
        fin.close()
    return 0


def cmd_info(args):
    data = open(args.input, "rb").read()
    es = demux.extract_es(data, args.container, args.track, args.pid)
    n = 0
    first = None
    bad_crc = 0
    for frame, srate, brate in demux.es_frames(es):
        if first is None:
            _, flags, _, _ = __import__(
                "ac3acm_tpu.host.parse", fromlist=["syncinfo"]).syncinfo(frame[:7])
            first = (srate, brate, flags)
        if args.check_crc:
            # crc1 covers bytes 2..5/8 of the frame, crc2 the whole frame;
            # both regions CRC to 0 when intact (the reference generates
            # these, A/52 §5.4.1/§5.10, but its decoder never verifies)
            words = len(frame) // 2
            fs58 = 2 * ((words >> 1) + (words >> 3))
            if (PK.ac3_crc(frame[2:fs58], 0) != 0
                    or PK.ac3_crc(frame[2:], 0) != 0):
                bad_crc += 1
        n += 1
    if first is None:
        print("no AC-3 frames found")
        return 1
    srate, brate, flags = first
    mode = ["1+1", "1/0", "2/0", "3/0", "2/1", "3/1", "2/2", "3/2"][flags & 7]
    lfe = "+LFE" if flags & T.A52_LFE else ""
    crcmsg = ""
    if args.check_crc:
        crcmsg = (f", CRC ok" if bad_crc == 0
                  else f", {bad_crc} frame(s) with bad CRC")
    print(f"AC-3 {mode}{lfe}, {srate} Hz, {brate // 1000} kbps, {n} frames, "
          f"{n * 1536 / srate:.2f}s{crcmsg}")
    return 1 if bad_crc else 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="ac3acm_tpu",
                                description="AC-3 codec tools (JAX device pipeline)")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="AC-3 -> PCM (a52dec parity)")
    d.add_argument("input")
    d.add_argument("-o", "--out", default=None)
    d.add_argument("--output", default="wav",
                   help="sink: wav wavdolby wav6 float null null4 null6 "
                        "peak peakdolby aif aifdolby")
    d.add_argument("-g", "--gain", type=float, default=0.0, help="gain in dB")
    d.add_argument("--sample-type", default="float",
                   choices=["float", "fixed", "double"],
                   help="decode arithmetic (LIBA52_FIXED/DOUBLE parity)")
    d.add_argument("--accuracy", default="reference",
                   choices=["reference", "fast"],
                   help="reference (default): order-exact IMDCT, "
                        "bit-exact vs the compiled reference on every "
                        "path; fast: matmul filterbank under the "
                        "0.02/0.001/0.002 LSB contract")
    d.add_argument("--backend", default="native",
                   choices=["native", "device"],
                   help="native: bit-exact C++ CPU path; device: JAX "
                        "device pipeline (float and fixed sample types)")
    d.add_argument("--no-drc", dest="drc", action="store_false")
    d.add_argument("--container", default="auto", choices=["auto", "es", "ps", "ts"])
    d.add_argument("--track", type=lambda x: int(x, 0), default=0)
    d.add_argument("--pid", type=lambda x: int(x, 0), default=0)
    d.add_argument("--chunk-frames", type=int, default=16)
    d.add_argument("-q", "--quiet", action="store_true")
    d.set_defaults(fn=cmd_decode)

    e = sub.add_parser("encode", help="PCM -> AC-3")
    e.add_argument("input", help=".wav or raw s16le")
    e.add_argument("-o", "--out", default=None)
    e.add_argument("-b", "--bitrate", type=int, default=None, help="kbit/s")
    e.add_argument("--rate", type=int, default=48000, help="raw input rate")
    e.add_argument("--channels", type=int, default=2, help="raw input chans")
    e.add_argument("-q", "--quiet", action="store_true")
    e.set_defaults(fn=cmd_encode)

    x = sub.add_parser("extract", help="container -> raw AC-3 ES")
    x.add_argument("input")
    x.add_argument("-o", "--out", default=None)
    x.add_argument("--container", default="auto", choices=["auto", "es", "ps", "ts"])
    x.add_argument("--track", type=lambda v: int(v, 0), default=0)
    x.add_argument("--pid", type=lambda v: int(v, 0), default=0)
    x.set_defaults(fn=cmd_extract)

    i = sub.add_parser("info", help="stream summary")
    i.add_argument("input")
    i.add_argument("--container", default="auto", choices=["auto", "es", "ps", "ts"])
    i.add_argument("--track", type=lambda v: int(v, 0), default=0)
    i.add_argument("--pid", type=lambda v: int(v, 0), default=0)
    i.add_argument("--check-crc", action="store_true",
                   help="verify crc1/crc2 of every frame")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, AssertionError, FileNotFoundError) as e:
        # argument/input problems get one clean line, not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
