"""Device IMDCT filterbank: one matmul + windowed overlap-add.

The full 512/256-pt IMDCT (pre-twiddle, split-radix IFFT, post-twiddle) is a
linear map of the 256 coefficients, so the hot path is

    [B, 256] @ [256, 384]  ->  z [B, 256] ++ new_delay [B, 128]

batched over streams*blocks*channels, followed by the elementwise KBD
window / overlap-add / bias epilogue (XLA fuses it into the matmul).
Matches liba52 a52_imdct_512/256 (imdct.c:258-345) to float32 rounding of
the dot products; the OLA/window adds use the reference's exact ordering.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables as T

HIGHEST = jax.lax.Precision.HIGHEST


@lru_cache(maxsize=1)
def _mats():
    # numpy, never jnp: jnp constants created inside a trace must not be
    # cached across traces (leaked-tracer hazard); XLA lifts these to
    # on-device constants per compilation anyway.
    z512, d512 = T.imdct512_matrices()
    z256, d256 = T.imdct256_matrices()
    w_long = np.concatenate([z512, d512], axis=1).astype(np.float32)
    w_short = np.concatenate([z256, d256], axis=1).astype(np.float32)
    win = T.kbd_window().astype(np.float32)
    return w_long, w_short, win


def filterbank(coeffs, delay, blksw, bias):
    """coeffs [..., 256], delay [..., 128], blksw [...] bool, bias [...]
    -> (out [..., 256], new_delay [..., 128]).

    blksw selects the short (256-pt) transform per row.  bias broadcasts.
    """
    w_long, w_short, win = _mats()
    # Two masked matmuls keep total FLOPs equal to one unmasked pass.
    blk = blksw[..., None]
    c_long = jnp.where(blk, 0.0, coeffs)
    c_short = jnp.where(blk, coeffs, 0.0)
    zd = (jnp.matmul(c_long, w_long, precision=HIGHEST)
          + jnp.matmul(c_short, w_short, precision=HIGHEST))
    z, dnew = zd[..., :256], zd[..., 256:]
    dfold = jnp.concatenate([delay, delay[..., ::-1]], axis=-1)
    out = z * win + dfold * win[::-1] + bias[..., None]
    return out, dnew


def convert_to_int16(biased, bias: float = 384.0):
    """Planar biased float -> int16 (AC3ASM.asm clip1 semantics).

    The reference exploits the IEEE bias trick: adding 384.0 quantizes the
    sample to the 2^-15 grid with round-to-nearest-even, then integer-clips.
    Subtracting the bias back and scaling is exact on that grid.
    """
    x = (biased - bias) * 32768.0
    return jnp.clip(jnp.round(x), -32768.0, 32767.0).astype(jnp.int16)
