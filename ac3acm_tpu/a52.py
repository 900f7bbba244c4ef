"""Drop-in a52_* / AC3_encode_* API surface (include/a52.h:56-65,
src/ac3enc/ac3enc.h:6-7 parity).

The reference's C API reshaped minimally for Python: a52_init returns a
state object, a52_frame/a52_block drive per-frame decode, a52_samples
returns the current block's planar samples.  Internally this drives the
bit-exact native CPU backend; use ac3acm_tpu.models / .parallel for the
batched device pipelines.
"""
from __future__ import annotations

import numpy as np

from . import tables as T
from .host.parse import syncinfo as _syncinfo

# output mode flags re-exported
A52_CHANNEL = T.A52_CHANNEL
A52_MONO = T.A52_MONO
A52_STEREO = T.A52_STEREO
A52_3F = T.A52_3F
A52_2F1R = T.A52_2F1R
A52_3F1R = T.A52_3F1R
A52_2F2R = T.A52_2F2R
A52_3F2R = T.A52_3F2R
A52_CHANNEL1 = T.A52_CHANNEL1
A52_CHANNEL2 = T.A52_CHANNEL2
A52_DOLBY = T.A52_DOLBY
A52_CHANNEL_MASK = T.A52_CHANNEL_MASK
A52_LFE = T.A52_LFE
A52_ADJUST_LEVEL = T.A52_ADJUST_LEVEL

MM_ACCEL_DJBFFT = 1          # accepted and ignored, like the reference's MMX
MM_ACCEL_X86_MMX = 0x80000000


class a52_state_t:
    """Decoder state (native backend + per-frame staging)."""

    def __init__(self):
        from .host.native import NativeDecoder
        self._dec = NativeDecoder()
        self._blocks = None          # [6, nch, 256] staged frame PCM
        self._blkno = 0
        self._nch = 0
        self._frame = None
        self._out_flags = None
        self._flags = 0
        self._level = 1.0
        self._bias = 0.0
        self._drc = True


def a52_init(mm_accel: int = 0) -> a52_state_t:
    return a52_state_t()


def a52_syncinfo(buf: bytes):
    """-> (frame_bytes, flags, sample_rate, bit_rate); 0 length = no sync."""
    size, flags, srate, brate = _syncinfo(bytes(buf[:7]))
    return size, flags, srate, brate


def a52_frame(state: a52_state_t, buf: bytes, flags: int,
              level: float = 1.0, bias: float = 0.0) -> int:
    """Stage one frame.  Returns 0 on success (decode happens lazily at the
    first a52_block).  flags/level/bias as in the C API; like the
    reference's a52_frame (liba52 parse.c:131-205) which writes the
    negotiated output mode back into *flags, the adjusted flags are
    readable via a52_flags(state)."""
    state._frame = bytes(buf)
    state._flags = flags
    state._level = level
    state._bias = bias
    state._blocks = None
    state._blkno = 0
    try:
        from .host.parse import A52Parser
        p = A52Parser()
        p.frame(state._frame, flags, level, bias)
        state._out_flags = int(p.s.output)
    except Exception:
        return 1
    return 0


def a52_dynrng(state: a52_state_t, call=None, data=None) -> None:
    """DRC control (liba52 parse.c:207-216 parity): a52_dynrng(state)
    disables dynamic range compression; a52_dynrng(state, fn, data) enables
    it with fn(range, data) -> range remapping the decoded gain before it
    scales the level (applied inside the native backend via a C callback)."""
    state._drc = bool(call)
    state._dec.set_drc_enabled(state._drc)
    if callable(call):
        state._dec.set_dynrng_call(lambda r, _fn=call, _d=data: _fn(r, _d))
    else:
        state._dec.set_dynrng_call(None)


def a52_block(state: a52_state_t) -> int:
    """Decode the next block; samples available via a52_samples."""
    if state._blocks is None:
        out = state._dec.decode_stream(state._frame, state._flags,
                                       state._level, state._bias)
        if out.shape[0] != 6:
            return 1
        state._blocks = out
        state._nch = out.shape[1]
        state._blkno = 0
    if state._blkno >= 6:
        return 1
    state._blkno += 1
    return 0


def a52_samples(state: a52_state_t) -> np.ndarray:
    """Planar float32 [nch, 256] for the block just decoded."""
    return state._blocks[state._blkno - 1]


def a52_flags(state: a52_state_t) -> int:
    """The *negotiated* output mode of the staged frame (what a52_samples
    will actually contain), matching the flags the reference writes back
    through a52_frame's flags pointer -- not the raw stream mode from
    syncinfo.  E.g. a 3F2R+LFE stream decoded with A52_STEREO reports
    A52_STEREO here."""
    out = getattr(state, "_out_flags", None)
    if out is not None:
        return out
    size, flags, _, _ = _syncinfo(state._frame[:7])
    return flags


def a52_free(state: a52_state_t) -> None:
    state._dec = None


# --- encoder entry points (ac3enc.h parity) --------------------------------

def AC3_encode_init(freq: int, bitrate: int, channels: int):
    """Returns an encoder handle (frame size via .frame_bytes); raises
    ValueError on unsupported parameters (the C returns 0)."""
    from .models.encoder import Encoder
    return Encoder(freq, bitrate, channels)


def AC3_encode_frame(enc, samples: np.ndarray,
                     chmap=None) -> bytes:
    """Encode one 1536-sample interleaved int16 frame."""
    pcm = np.asarray(samples, np.int16).reshape(T.FRAME_SAMPLES, -1)
    if chmap is not None:
        pcm = pcm[:, np.asarray(chmap)]
    return enc.encode(pcm)
