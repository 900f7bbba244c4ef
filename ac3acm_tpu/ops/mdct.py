"""Encoder forward MDCT: exact fixed-point semantics, vectorized.

The reference encoder's 512-pt MDCT is int16 block-float arithmetic: a
radix-2 128-pt complex FFT whose every butterfly halves (>>1) and whose
twiddle products truncate (>>15), with results stored through int16
(ac3enc.cpp:441-603).  Bit-exact output frames require reproducing those
truncations and wraps exactly, so this implementation runs the same
dataflow on int32 lanes with explicit wrap-to-int16 at every point the C
code stores through a short.  Everything is batched over leading axes --
the per-stage butterflies are pure gathers/elementwise ops on the VPU, and
six blocks x channels x streams vectorize together.

(The *decoder* filterbank is float and lives in ops/filterbank.py as a
matmul; this int path is encode-only, where the contract is bit-exact
frames rather than FLOPs.)
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables as T

N = 512
NBITS = 7          # 128-pt FFT


def _fix15(a32: np.ndarray) -> np.ndarray:
    """fix15 on a float32 input: v = (int)(a * 32768.0f), clamp +-32767."""
    a32 = a32.astype(np.float32)
    v = np.trunc((a32 * np.float32(32768.0)).astype(np.float32)).astype(np.int64)
    return np.clip(v, -32767, 32767).astype(np.int32)


@lru_cache(maxsize=1)
def _twiddles():
    # fft_init: alpha = (float)(2*pi*i/n); fix15((float)cos(alpha))
    i = np.arange(64)
    alpha = (2 * np.pi * i / 128.0).astype(np.float32)
    costab = _fix15(np.cos(alpha.astype(np.float64)).astype(np.float32))
    sintab = _fix15(np.sin(alpha.astype(np.float64)).astype(np.float32))
    # encoder init: alpha = (float)(2*pi*(i+1/8)/512); fix15((float)-cos(alpha))
    i = np.arange(128)
    alpha = (2 * np.pi * (i + 1.0 / 8.0) / N).astype(np.float32)
    xcos1 = _fix15((-np.cos(alpha.astype(np.float64))).astype(np.float32))
    xsin1 = _fix15((-np.sin(alpha.astype(np.float64))).astype(np.float32))
    rev = np.zeros(128, np.int32)
    for k in range(128):
        m = 0
        for j in range(NBITS):
            m |= ((k >> j) & 1) << (NBITS - 1 - j)
        rev[k] = m
    return costab, sintab, xcos1, xsin1, rev


def _wrap16(x):
    """int32 -> value of (int16)x, kept in int32 lanes."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _fft128(re, im):
    """Batched in-place-equivalent 128-pt FFT with the reference's exact
    >>1 / >>15 truncations and int16 stores.  re/im: [..., 128] int32."""
    costab, sintab, xcos1, xsin1, rev = _twiddles()
    re = re[..., rev]
    im = im[..., rev]

    def bf(pre, pim, qre, qim):
        # BF macro: p' = (p+q)>>1, q' = (p-q)>>1, stored to int16
        return (_wrap16((pre + qre) >> 1), _wrap16((pim + qim) >> 1),
                _wrap16((pre - qre) >> 1), _wrap16((pim - qim) >> 1))

    # pass 0: stride-2 pairs
    p, q = re[..., 0::2], re[..., 1::2]
    pi_, qi = im[..., 0::2], im[..., 1::2]
    a, b, c, d = bf(p, pi_, q, qi)
    re = _ilv(a, c)
    im = _ilv(b, d)

    # pass 1: groups of 4; second butterfly uses (q.im, -q.re)
    p0, p1, p2, p3 = (re[..., k::4] for k in range(4))
    q0, q1, q2, q3 = (im[..., k::4] for k in range(4))
    a0, b0, c0, d0 = bf(p0, q0, p2, q2)
    a1, b1, c1, d1 = bf(p1, q1, q3, -p3)
    re = _ilv4(a0, a1, c0, c1)
    im = _ilv4(b0, b1, d0, d1)

    # passes 2..6: gather/scatter-free -- each stage's (p, q) lanes are a
    # pure [nblocks, 2, half] reshape view (position j*2*half + k*half + t),
    # so the butterflies are strided-slice reads + a stack/reshape write.
    # relayouts + elementwise, no serializing scatter
    lead = re.shape[:-1]
    for s in range(2, NBITS):
        half = 1 << s                 # butterflies per group
        nblocks = 128 >> (s + 1)
        t = np.arange(half)
        l = (t * nblocks).astype(np.int32)     # twiddle indices, l[0]=0
        ct = jnp.asarray(costab[l])            # [half], broadcasts over j
        st = jnp.asarray(sintab[l])
        notw = jnp.asarray(t == 0)
        re4 = re.reshape(lead + (nblocks, 2, half))
        im4 = im.reshape(lead + (nblocks, 2, half))
        pre, qre = re4[..., 0, :], re4[..., 1, :]
        pim, qim = im4[..., 0, :], im4[..., 1, :]
        # CMUL(tmp, costab[l], -sintab[l], q)
        tre = (ct * qre + st * qim) >> 15
        tim = (ct * qim - st * qre) >> 15
        tre = jnp.where(notw, qre, tre)
        tim = jnp.where(notw, qim, tim)
        a, b, c, d = bf(pre, pim, tre, tim)
        re = jnp.stack([a, c], axis=-2).reshape(lead + (128,))
        im = jnp.stack([b, d], axis=-2).reshape(lead + (128,))
    return re, im


def _ilv(a, b):
    out = jnp.stack([a, b], axis=-1)
    return out.reshape(out.shape[:-2] + (a.shape[-1] * 2,))


def _ilv4(a, b, c, d):
    out = jnp.stack([a, b, c, d], axis=-1)
    return out.reshape(out.shape[:-2] + (a.shape[-1] * 4,))


def mdct512(x):
    """x [..., 512] int32 (int16-valued windowed, normalized samples)
    -> coefficients [..., 256] int32 (full precision, like the C 'long')."""
    _, _, xcos1, xsin1, _ = _twiddles()
    xc = jnp.asarray(xcos1)
    xs = jnp.asarray(xsin1)
    # rotation: rot[i] = -x[i+384] (i<128), rot[i] = x[i-128] (i>=128)
    rot = jnp.concatenate([-x[..., 384:], x[..., :384]], axis=-1)
    rot = _wrap16(rot)
    # pre rotation (ints, no wrap until the CMUL store); all strided
    # slices (rot[2i], rot[511-2i], rot[256+2i], rot[255-2i]), no gathers
    reA = (rot[..., 0:256:2] - rot[..., 257::2][..., ::-1]) >> 1
    imA = (-(rot[..., 256::2] - rot[..., 1:256:2][..., ::-1])) >> 1
    # CMUL(x.re, x.im, re, im, -xcos1, xsin1) stored to int16
    zre = _wrap16((reA * (-xc) - imA * xs) >> 15)
    zim = _wrap16((reA * xs + (-xc) * imA) >> 15)
    fre, fim = _fft128(zre, zim)
    # post rotation: CMUL(re1, im1, re, im, xsin1, xcos1), full int precision
    re1 = (fre * xs - fim * xc) >> 15
    im1 = (fre * xc + xs * fim) >> 15
    # out[2i] = im1[i]; out[255-2i] = re1[i]  <=>  out[2j+1] = re1[127-j]:
    # a single interleave, no scatter
    return _ilv(im1, re1[..., ::-1])


def av_log2(v):
    """floor(log2(v)) for v >= 1, 0 for v == 0 (ff_log2_tab semantics)."""
    acc = jnp.zeros_like(v)
    for k in range(1, 31):
        acc = acc + (v >= (1 << k)).astype(v.dtype)
    return acc


def window_norm_block(last, cur):
    """One block's framing: window + block-float normalize.

    last/cur: [..., 256] int32 (int16-valued).  Returns (windowed [..., 512],
    exp_shift [...] = the 'v' left-shift, exp_samples = v - 9)."""
    w = jnp.asarray(T.enc_window_int16().astype(np.int32))
    x = jnp.concatenate([last, cur], axis=-1)
    i = np.arange(256)
    front = _wrap16((x[..., :256] * w) >> 15)
    back = _wrap16((x[..., 511 - i] * w) >> 15)[..., ::-1]
    x = jnp.concatenate([front, back], axis=-1)
    vmax = jax.lax.reduce(jnp.abs(x), np.int32(0), jax.lax.bitwise_or,
                          (x.ndim - 1,))
    v = 14 - av_log2(vmax)
    v = jnp.maximum(v, 0)
    x = _wrap16(x << v[..., None])
    return x, v, v - 9


def extract_exponents(coef, exp_samples):
    """coef [..., 256] int32, exp_samples [...] -> (exp [..., 256] int32,
    coef with overrange values zeroed)."""
    v = jnp.abs(coef)
    e = 23 - av_log2(v) + exp_samples[..., None]
    e = jnp.where(v == 0, 24, e)
    over = e >= 24
    e = jnp.where(over, 24, e)
    coef = jnp.where(over & (v != 0), 0, coef)
    return e, coef
