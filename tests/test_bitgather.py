"""ops.bitgather: bitfield gather vs the BitReader oracle."""
import numpy as np
import jax.numpy as jnp

import ac3acm_tpu.ops.bitgather as BG

TS = 128


def _u16(x):
    """Field values as the oracle's unsigned 16-bit patterns."""
    return np.asarray(x).astype(np.int64) & 0xFFFF


def _random_case(rng, N, S, MB):
    data = rng.integers(0, 256, (N, MB), dtype=np.uint8)
    widths = rng.integers(0, 17, (N, S)).astype(np.int32)
    offs = np.zeros((N, S), np.int32)
    for n in range(N):
        # monotone offsets: cumsum of widths with random gaps
        gaps = rng.integers(0, 3, S)
        o = np.cumsum(widths[n] + gaps) - widths[n] - gaps
        o = np.minimum(o, MB * 8 - 17)
        offs[n] = o
    return data, offs, widths


def test_extract_fields_random():
    rng = np.random.default_rng(7)
    N, S, MB = 4, 4 * TS, 1536
    data, offs, widths = _random_case(rng, N, S, MB)
    got = _u16(BG.extract_fields(
        jnp.asarray(data), jnp.asarray(offs), jnp.asarray(widths)))
    want = BG.reference_extract(data, offs, widths)
    assert (got == want).all(), np.argwhere(got != want)[:8]


def test_extract_fields_dense_16bit():
    """Worst-case density: every slot a 16-bit field back to back, at
    bit phases 0 and 5."""
    rng = np.random.default_rng(3)
    N, S = 2, 2 * TS
    MB = (S * 16) // 8 + 192
    data = rng.integers(0, 256, (N, MB), dtype=np.uint8)
    widths = np.full((N, S), 16, np.int32)
    offs = np.tile(np.arange(S, dtype=np.int32) * 16, (N, 1))
    # misalign the second row by 5 bits
    offs[1] += 5
    got = _u16(BG.extract_fields(
        jnp.asarray(data), jnp.asarray(offs), jnp.asarray(widths)))
    want = BG.reference_extract(data, offs, widths)
    assert (got == want).all()


def test_extract_fields_tail_of_buffer():
    """Fields at the very end of the byte buffer (the zero-padded read
    tail)."""
    rng = np.random.default_rng(11)
    N, S, MB = 2, TS, 3840
    data = rng.integers(0, 256, (N, MB), dtype=np.uint8)
    widths = rng.integers(1, 17, (N, S)).astype(np.int32)
    base = MB * 8 - 16 * S - 8
    offs = base + np.tile(np.arange(S, dtype=np.int32) * 16, (N, 1))
    got = _u16(BG.extract_fields(
        jnp.asarray(data), jnp.asarray(offs), jnp.asarray(widths)))
    want = BG.reference_extract(data, offs, widths)
    assert (got == want).all()


def test_extract_i16_table():
    """16-bit table gather (the dither-orbit lookup): entry-indexed
    values from a shared int16 table at unordered indices, incl.
    negative (high-bit) values and both table ends."""
    rng = np.random.default_rng(17)
    TB = 65535
    table = rng.integers(-32768, 32768, TB).astype(np.int16)
    N, S = 2, 2048
    offs = rng.integers(0, TB, (N, S)).astype(np.int32)
    offs[:, 0] = 0
    offs[:, -1] = TB - 1
    got = np.asarray(BG.extract_i16_table(table, jnp.asarray(offs)))
    want = table[offs]
    assert (got == want).all(), np.argwhere(got != want)[:5]
