"""Build the reference liba52 + ac3enc from /root/reference as CPU shared libs.

Used only as a *test oracle*: the differential tests decode/encode with the
reference C code and compare against this implementation.  Nothing
from the reference is copied into this repository; we compile it in a scratch
directory straight from the read-only reference checkout.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

REF = Path("/root/reference/a52dec-0.7.5-cvs")
REF_ENC = Path("/root/reference/src/ac3enc")
BUILD = Path(__file__).resolve().parent.parent / ".refbuild"

_CONFIG_H = """
#define HAVE_MEMALIGN 1
#define HAVE_STRUCT_TIMEVAL 1
"""

# The encoder is written against MSVC/Windows headers; shim just enough to
# compile it with g++ on Linux.  (unsigned long is 64-bit on LP64, but the
# bit writer stores through an unsigned-long pointer advancing 4 bytes, so we
# must force 32-bit semantics via macro.)
_ENC_SHIM_H = r"""
#ifndef REF_ENC_SHIM_H
#define REF_ENC_SHIM_H
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>
#define _ASSERT(x) ((void)0)
#define _AMD64_ 1
static inline uint32_t _byteswap_ulong(uint32_t v) { return __builtin_bswap32(v); }
#endif
"""

_ENC_WRAP_CPP = r"""
// Wrapper translation unit: forces 32-bit 'unsigned long' semantics for the
// encoder's put_bits store, includes the reference encoder, and exports a
// plain C API.
#include "enc_shim.h"
#define windows_h_included
#define long int              /* LP64 -> force 32-bit long inside ac3enc.cpp */
#define unsigned_long uint32_t
#include "ac3enc_body.cpp"
#undef long
extern "C" {
int ref_encode_init(int freq, int bitrate, int channels) {
    return AC3_encode_init(freq, bitrate, channels);
}
int ref_encode_frame(unsigned char *dst, short *samples, unsigned char *chmap) {
    return AC3_encode_frame(dst, samples, chmap);
}
// direct MDCT probe (call ref_encode_init first to build the twiddles)
void ref_mdct512(int *out, short *in) { mdct512(out, in); }
// the reference encoder keeps state in a static global; clear it so
// successive oracle uses start fresh like a new driver instance would
void ref_encode_reset() { memset(&ac3enc_state, 0, sizeof(ac3enc_state)); }
// encoder-side allocator probe
void ref_enc_bit_alloc(unsigned char *bap_out, signed char *expv,
                       int start, int end, int snroffset, int fgain,
                       int is_lfe, int fscod, int halfratecod,
                       int sdecay, int fdecay, int sgain, int dbknee,
                       int floorv) {
    AC3BitAllocParameters p;
    p.fscod = fscod; p.halfratecod = halfratecod;
    p.sdecay = sdecay; p.fdecay = fdecay; p.sgain = sgain;
    p.dbknee = dbknee; p.floor = floorv; p.cplfleak = 0; p.cplsleak = 0;
    ac3_common_init();
    ac3_parametric_bit_allocation(&p, bap_out, expv, start, end, snroffset,
                                  fgain, is_lfe, 2, 0, NULL, NULL, NULL);
}
}

// Decoder-side bit-allocation probe (drives liba52's a52_bit_allocate on a
// synthetic state so the spec-form allocator can be fuzzed against it).
extern "C" {
#include <inttypes.h>
#include "a52.h"
#include "a52_internal.h"
}
extern "C" int ref_bit_allocate(
    const unsigned char *exp, int bndstart, int start, int end,
    int fscod, int halfrate, int bai, int ba_bai, int csnroffst,
    int deltbae, const signed char *deltba, int fastleak, int slowleak,
    signed char *bap_out)
{
    a52_state_t st;
    memset(&st, 0, sizeof(st));
    st.fscod = fscod;
    st.halfrate = halfrate;
    st.bai = bai;
    st.csnroffst = csnroffst;
    ba_t ba;
    memset(&ba, 0, sizeof(ba));
    ba.bai = ba_bai;
    ba.deltbae = deltbae;
    if (deltba) memcpy(ba.deltba, deltba, 50);
    expbap_t eb;
    memset(&eb, 0, sizeof(eb));
    memcpy(eb.exp, exp, 256);
    a52_bit_allocate(&st, &ba, bndstart, start, end, fastleak, slowleak, &eb);
    memcpy(bap_out, eb.bap, 256);
    return 0;
}
"""


def build_variant(kind: str) -> Path:
    """Compile the 5 liba52 decoder sources with -DLIBA52_FIXED or
    -DLIBA52_DOUBLE into a separate oracle .so (sample-type variants)."""
    assert kind in ("fixed", "double")
    BUILD.mkdir(exist_ok=True)
    so = BUILD / f"libref_{kind}.so"
    stamp = BUILD / f"stamp_{kind}"
    srcs = sorted((REF / "liba52").glob("*.c"))
    sig = "|".join(f"{s}:{s.stat().st_mtime}" for s in srcs) + "v1"
    if so.exists() and stamp.exists() and stamp.read_text() == sig:
        return so
    (BUILD / "config.h").write_text(_CONFIG_H)
    dec_srcs = [str(REF / "liba52" / f) for f in
                ("bitstream.c", "parse.c", "bit_allocate.c",
                 "imdct.c", "downmix.c")]
    cmd = (["gcc", "-O2", "-fPIC", "-shared", f"-DLIBA52_{kind.upper()}",
            "-o", str(so), f"-I{BUILD}", f"-I{REF}/include",
            f"-I{REF}/liba52"] + dec_srcs + ["-lm"])
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    stamp.write_text(sig)
    return so


class RefVariant:
    """Decoder oracle for a LIBA52_FIXED / LIBA52_DOUBLE build."""

    def __init__(self, kind: str):
        import numpy as np
        self.kind = kind
        self.lib = ctypes.CDLL(str(build_variant(kind)))
        self.ct = ctypes.c_int32 if kind == "fixed" else ctypes.c_double
        self.np_t = np.int32 if kind == "fixed" else np.float64
        L = self.lib
        L.a52_init.restype = ctypes.c_void_p
        L.a52_init.argtypes = [ctypes.c_uint32]
        L.a52_samples.restype = ctypes.POINTER(self.ct)
        L.a52_samples.argtypes = [ctypes.c_void_p]
        L.a52_syncinfo.restype = ctypes.c_int
        L.a52_syncinfo.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
        L.a52_frame.restype = ctypes.c_int
        L.a52_frame.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(self.ct), self.ct]
        L.a52_block.restype = ctypes.c_int
        L.a52_block.argtypes = [ctypes.c_void_p]
        L.a52_free.argtypes = [ctypes.c_void_p]

    def decode_stream(self, es: bytes, flags: int, level=None, bias=None,
                      adjust_level: bool = True):
        """Returns (flags, blocks[n, 256*nch]) in the variant's sample type.

        Default level/bias follow the CLI sinks: fixed 1<<26 / 0
        (audio_out_internal.h:30-32), double 1.0 / 0.0 (float sink)."""
        import numpy as np
        if level is None:
            level = (1 << 26) if self.kind == "fixed" else 1.0
        if bias is None:
            bias = 0
        st = self.lib.a52_init(0)
        out_blocks = []
        out_flags = None
        pos = 0
        f = ctypes.c_int()
        sr = ctypes.c_int()
        br = ctypes.c_int()
        while pos + 7 <= len(es):
            n = self.lib.a52_syncinfo(es[pos:pos + 7], ctypes.byref(f),
                                      ctypes.byref(sr), ctypes.byref(br))
            if n == 0:
                pos += 1
                continue
            if pos + n > len(es):
                break
            fl = ctypes.c_int(flags | (A52_ADJUST_LEVEL if adjust_level
                                       else 0))
            lv = self.ct(level)
            # a52_frame keeps the buffer pointer for a52_block's bitstream
            # reads -- the frame bytes must stay alive through the blocks
            frame = es[pos:pos + n]
            if self.lib.a52_frame(st, frame, ctypes.byref(fl),
                                  ctypes.byref(lv), self.ct(bias)):
                pos += n
                continue
            out_flags = fl.value
            nch = _nch_from_flags(fl.value)
            ok = True
            blocks = []
            for _ in range(6):
                if self.lib.a52_block(st):
                    ok = False
                    break
                smp = self.lib.a52_samples(st)
                blocks.append(
                    np.ctypeslib.as_array(smp, shape=(256 * nch,)).copy())
            if ok:
                out_blocks.extend(blocks)
            pos += n
        self.lib.a52_free(st)
        import numpy as np
        return out_flags, (np.stack(out_blocks) if out_blocks
                           else np.zeros((0, 0), self.np_t))


_VARIANTS: dict = {}


def get_ref_variant(kind: str) -> RefVariant:
    if kind not in _VARIANTS:
        _VARIANTS[kind] = RefVariant(kind)
    return _VARIANTS[kind]


def build() -> Path:
    BUILD.mkdir(exist_ok=True)
    so = BUILD / "libref.so"
    stamp = BUILD / "stamp"
    srcs = sorted((REF / "liba52").glob("*.c")) + [REF_ENC / "ac3enc.cpp"]
    sig = "|".join(f"{s}:{s.stat().st_mtime}" for s in srcs) + "v9"
    if so.exists() and stamp.exists() and stamp.read_text() == sig:
        return so

    (BUILD / "config.h").write_text(_CONFIG_H)
    (BUILD / "enc_shim.h").write_text(_ENC_SHIM_H)
    # The encoder body: include via preprocessor after stripping the Windows
    # includes (handled with -D tricks below plus a filtered copy in the
    # scratch dir; the filtered copy never enters the repo).
    body = (REF_ENC / "ac3enc.cpp").read_text()
    body = body.replace("#include <windows.h>", "")
    body = body.replace("#include <crtdbg.h>", "")
    (BUILD / "ac3enc_body.cpp").write_text(body)
    (BUILD / "enc_wrap.cpp").write_text(_ENC_WRAP_CPP)

    dec_srcs = [str(REF / "liba52" / f) for f in
                ("bitstream.c", "parse.c", "bit_allocate.c", "imdct.c", "downmix.c")]
    cmd = (
        ["gcc", "-O2", "-fPIC", "-shared", "-o", str(so),
         f"-I{BUILD}", f"-I{REF}/include", f"-I{REF}/liba52", f"-I{REF_ENC}"]
        + dec_srcs + [str(BUILD / "enc_wrap.cpp"), "-lm", "-lstdc++"]
    )
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    stamp.write_text(sig)
    return so


class RefLib:
    """ctypes bindings for the reference decoder/encoder oracle."""

    def __init__(self):
        self.lib = ctypes.CDLL(str(build()))
        L = self.lib
        L.a52_init.restype = ctypes.c_void_p
        L.a52_init.argtypes = [ctypes.c_uint32]
        L.a52_samples.restype = ctypes.POINTER(ctypes.c_float)
        L.a52_samples.argtypes = [ctypes.c_void_p]
        L.a52_syncinfo.restype = ctypes.c_int
        L.a52_syncinfo.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
        L.a52_frame.restype = ctypes.c_int
        L.a52_frame.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_float), ctypes.c_float]
        L.a52_block.restype = ctypes.c_int
        L.a52_block.argtypes = [ctypes.c_void_p]
        L.a52_free.argtypes = [ctypes.c_void_p]
        L.a52_imdct_init.argtypes = [ctypes.c_uint32]
        L.a52_imdct_512.argtypes = [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_float]
        L.a52_imdct_256.argtypes = [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_float]
        L.ref_encode_init.restype = ctypes.c_int
        L.ref_encode_init.argtypes = [ctypes.c_int] * 3
        L.ref_encode_frame.restype = ctypes.c_int
        L.ref_encode_frame.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_short),
                                       ctypes.POINTER(ctypes.c_ubyte)]
        L.ref_bit_allocate.restype = ctypes.c_int

    def bit_allocate(self, exp, start, end, fscod=0, halfrate=0, bai=0,
                     ba_bai=0, csnroffst=0, deltbae=2, deltba=None,
                     bndstart=0, fastleak=0, slowleak=0):
        import numpy as np
        exp = np.ascontiguousarray(exp, dtype=np.uint8)
        bap = np.zeros(256, dtype=np.int8)
        d = (np.ascontiguousarray(deltba, dtype=np.int8) if deltba is not None
             else np.zeros(50, dtype=np.int8))
        self.lib.ref_bit_allocate(
            exp.ctypes.data_as(ctypes.c_char_p), bndstart, start, end,
            fscod, halfrate, bai, ba_bai, csnroffst, deltbae,
            d.ctypes.data_as(ctypes.c_char_p), fastleak, slowleak,
            bap.ctypes.data_as(ctypes.c_char_p))
        return bap

    # ---- decoder oracle ----------------------------------------------------

    def imdct(self, data, delay, bias=0.0, short_block=False):
        import numpy as np
        self.lib.a52_imdct_init(0)
        d = np.ascontiguousarray(data, dtype=np.float32).copy()
        dl = np.ascontiguousarray(delay, dtype=np.float32).copy()
        fn = self.lib.a52_imdct_256 if short_block else self.lib.a52_imdct_512
        fn(d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
           dl.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
           ctypes.c_float(bias))
        return d, dl

    def decode_stream(self, es: bytes, flags: int, level: float = 1.0,
                      bias: float = 0.0, adjust_level: bool = True):
        """Decode an elementary stream; returns (flags, blocks[n,256*nch])."""
        import numpy as np
        st = self.lib.a52_init(0)
        out_blocks = []
        out_flags = None
        pos = 0
        f = ctypes.c_int()
        sr = ctypes.c_int()
        br = ctypes.c_int()
        while pos + 7 <= len(es):
            n = self.lib.a52_syncinfo(es[pos:pos + 7], ctypes.byref(f),
                                      ctypes.byref(sr), ctypes.byref(br))
            if n == 0:
                pos += 1
                continue
            if pos + n > len(es):
                break
            frame = es[pos:pos + n]
            fl = ctypes.c_int(flags | (A52_ADJUST_LEVEL if adjust_level else 0))
            lv = ctypes.c_float(level)
            if self.lib.a52_frame(st, frame, ctypes.byref(fl), ctypes.byref(lv),
                                  ctypes.c_float(bias)):
                pos += n
                continue
            out_flags = fl.value
            nch = _nch_from_flags(fl.value)
            ok = True
            blocks = []
            for _ in range(6):
                if self.lib.a52_block(st):
                    ok = False
                    break
                smp = self.lib.a52_samples(st)
                blocks.append(np.ctypeslib.as_array(smp, shape=(256 * nch,)).copy())
            if ok:
                out_blocks.extend(blocks)
            pos += n
        self.lib.a52_free(st)
        import numpy as np
        return out_flags, (np.stack(out_blocks) if out_blocks else np.zeros((0, 0)))

    # ---- encoder oracle ----------------------------------------------------

    def encode(self, pcm, freq: int, bitrate: int):
        """pcm: int16 [nsamples, nch] interleaved layout. Returns AC-3 bytes."""
        import numpy as np
        pcm = np.ascontiguousarray(pcm, dtype=np.int16)
        nch = pcm.shape[1]
        self.lib.ref_encode_reset()
        fs = self.lib.ref_encode_init(freq, bitrate * 1000, nch)
        assert fs > 0, "ref encoder init failed"
        chmap = (ctypes.c_ubyte * nch)(*range(nch))
        out = bytearray()
        buf = ctypes.create_string_buffer(3840)
        nfr = pcm.shape[0] // 1536
        for i in range(nfr):
            chunk = np.ascontiguousarray(pcm[i * 1536:(i + 1) * 1536])
            n = self.lib.ref_encode_frame(
                buf, chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_short)), chmap)
            out += buf.raw[:n]
        return bytes(out)


A52_ADJUST_LEVEL = 32
_NCH_TBL = {0: 2, 1: 1, 2: 2, 3: 3, 4: 3, 5: 4, 6: 4, 7: 5, 8: 1, 9: 1, 10: 2}


def _nch_from_flags(flags: int) -> int:
    return _NCH_TBL[flags & 15] + (1 if flags & 16 else 0)


_REF = None


def get_ref() -> RefLib:
    global _REF
    if _REF is None:
        _REF = RefLib()
    return _REF
