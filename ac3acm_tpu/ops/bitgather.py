"""Bitfield gather: the device half of bitstream unpack.

Extracts many variable-width (<=16 bit) fields from per-row byte buffers
at arbitrary bit offsets.  This is the primitive under the raw-H2D decode
path (ops.unpack_device): the host ships raw AC-3 frame bytes + side-info
offsets, and the device pulls exponent groups, coupling coordinates and
mantissa codes out of the bits itself (reference semantics:
liba52/bitstream.h:53-77, re-expressed as a batched gather rather than a
cursor).

Each field is one XLA gather of the 24-bit big-endian window starting at
byte off>>3, then a shift and a mask -- exactly BitReader.gather's
arithmetic (host/bitio.py:53-68), which reference_extract below uses as
the oracle.  A field of width <= 16 at bit phase <= 7 always fits the
window.  Buffers are zero-padded by two bytes so the window of the last
byte stays in bounds.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _windows(data):
    """[N, MB] uint8 -> [N, MB] int32 of 24-bit windows
    b[p]<<16 | b[p+1]<<8 | b[p+2] (zero past the buffer end)."""
    d = jnp.pad(data, ((0, 0), (0, 2))).astype(jnp.int32)
    MB = data.shape[-1]
    return (d[:, :MB] << 16) | (d[:, 1:MB + 1] << 8) | d[:, 2:MB + 2]


def extract_fields(data, offsets, widths):
    """data [N, MB] uint8; offsets/widths [N, S] int32 (bit offsets,
    widths 0..16).  Returns [N, S] int32 unsigned field values; a width-0
    slot reads 0 whatever its offset."""
    win = jnp.take_along_axis(_windows(data), offsets >> 3, axis=1,
                              mode="clip")
    shift = 24 - (offsets & 7) - widths
    return (win >> shift) & ((jnp.int32(1) << widths) - 1)


def extract_i16_table(table, index):
    """Gather 16-bit values from ONE shared table at per-slot entry
    indices: table [TB] (any 16-bit dtype), index [N, S] int32 ->
    [N, S] int16 (the table's bit pattern, signed)."""
    tab = jnp.asarray(np.asarray(table).view(np.int16))
    return jnp.take(tab, index, mode="clip")


def reference_extract(data: np.ndarray, offsets: np.ndarray,
                      widths: np.ndarray) -> np.ndarray:
    """numpy oracle (BitReader.gather semantics) for tests."""
    N = data.shape[0]
    out = np.zeros(offsets.shape, np.int32)
    from ..host.bitio import BitReader
    for n in range(N):
        br = BitReader(data[n].tobytes())
        out[n] = br.gather(offsets[n].astype(np.int64),
                           widths[n].astype(np.int64)).astype(np.int32)
    return out
