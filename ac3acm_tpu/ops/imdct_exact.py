"""Order-exact IMDCT filterbank: bit-identical output for every sample type.

The matmul filterbank (ops/filterbank.py) is the fast-mode path; its
dot-product summation order differs from the reference's split-radix IFFT,
leaving ~1 ulp discrepancies.  This module replays the reference's exact
evaluation order (imdct.c:77-345: the djbfft-style ifft2/4/8/pass butterfly
sequence, pre/post twiddles, windowed overlap-add) as elementwise ops,
batched over rows -- every add and multiply matches the C code
operation-for-operation.

The whole pipeline is parameterized over an arithmetic variant (the same
axis the reference expresses as SAMPLE/MUL macros, a52_internal.h:124-163):

  * "float"  -- float32; multiplies via an f64 round-trip so XLA cannot
    FMA-contract them (bit-exact vs the float build).
  * "fixed"  -- LIBA52_FIXED int32 Q30: MUL is the reference's split
    16-bit-halves multiply with uint32 wraparound (a52_internal.h:144-150),
    reproduced with int32 two's-complement ops; tables are
    SAMPLE()-truncated to Q30.  Bit-exact vs the -DLIBA52_FIXED build.

Used for the bit-matching decode modes and as the strongest test oracle.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables as T


@lru_cache(maxsize=4)
def backend_contracts_fma(platform: str) -> bool:
    """Empirical once-per-platform probe: does this platform's compiled
    code FMA-contract f32 mul+add chains (skipping the product rounding
    the reference performs)?  Measured on XLA:CPU: it contracts (LLVM
    emits fmuladd -- jit(a*b + c*d) deviates from the separately-rounded
    value by ~1 ulp of the terms).  The probe compares a compiled
    mul+add+add chain, placed on the platform's first device, against
    numpy's correctly-rounded single-op arithmetic."""
    rng = np.random.default_rng(12345)
    a, b, c, d = ((rng.standard_normal(1024) * 4).astype(np.float32)
                  for _ in range(4))
    strict = (a * b + (c * d)).astype(np.float32)  # numpy: separate rounding
    strict2 = (strict + np.float32(384.0)).astype(np.float32)

    def f(a, b, c, d):
        return (a * b + c * d) + jnp.float32(384.0)

    # the first call often happens while TRACING a caller's jit; a plain
    # jax.jit call would inline into that trace, so lower+compile to an
    # executable and invoke it directly (runs eagerly in any context)
    dev = jax.sharding.SingleDeviceSharding(
        jax.local_devices(backend=platform)[0])
    spec = jax.ShapeDtypeStruct(a.shape, a.dtype)
    exe = jax.jit(f, in_shardings=dev, out_shardings=dev).lower(
        spec, spec, spec, spec).compile()
    got = np.asarray(exe(a, b, c, d))
    return bool((got != strict2).any())


def _mul_float(a, b):
    """Correctly-rounded float32 product that the compiler cannot
    FMA-contract into a following add.

    Two guards, both conditional on need:
      * with x64 enabled, computing the product in f64 and rounding to
        f32 is bit-identical to an f32 multiply, and the type boundary
        forces the rounding to happen;
      * with x64 disabled (the production default -- the f64 cast is
        then a no-op), adding an opaque zero (optimization_barrier'd
        scalar) on backends whose codegen contracts (XLA:CPU).  LLVM
        then either contracts the product into THIS add --
        fma(a, b, 0) == fl(a*b), the separately-rounded product -- or
        keeps fadd(p, 0) == p; both are exact, and the result is no
        longer a bare fmul so it cannot contract into a downstream add.
        (Barrier-wrapping the product itself does NOT work: the CPU
        fusion emitter contracts straight through it -- measured.)  Only
        visible change: a -0.0 product becomes +0.0.  Where the probe
        shows no contraction the guard is skipped so the exact path
        keeps fusing freely.
    """
    p = (a.astype(jnp.float64) * b).astype(jnp.float32)
    if (not jax.config.jax_enable_x64
            and backend_contracts_fma(jax.default_backend())):
        p = p + jax.lax.optimization_barrier(jnp.float32(0.0))
    return p


def _mul_fixed(a, b):
    """FixedOps::MUL (native/ac3sample.inc:33-38): Q30 multiply as split
    16-bit halves with mod-2^32 intermediates.  int32 two's-complement
    wraparound in XLA reproduces the uint32 arithmetic bit-for-bit."""
    lo = (a & 0xFFFF) * (b >> 16) + (a >> 16) * (b & 0xFFFF)
    return (lo >> 14) + (((a >> 16) * (b >> 16)) << 2)


@lru_cache(maxsize=1)
def _tw_float():
    # numpy only: jnp constants must not be cached across traces
    return dict(T.imdct_twiddles())


@lru_cache(maxsize=1)
def _tw_fixed():
    """The same runtime tables SAMPLE()-quantized to int32 Q30 (truncation
    toward zero, matching the C cast in ac3sample.inc:31)."""
    tw = dict(T.imdct_twiddles_f64())
    out = {}
    for k, v in tw.items():
        if k == "fftorder":
            out[k] = v
        else:
            out[k] = np.trunc(np.asarray(v, np.float64)
                              * 1073741824.0).astype(np.int64).astype(np.int32)
    return out


@lru_cache(maxsize=2)
def _build(variant: str):
    """All filterbank entry points for one arithmetic variant."""
    _m = _mul_float if variant == "float" else _mul_fixed
    _tw = _tw_float if variant == "float" else _tw_fixed

    # complex values as (re, im) pairs of [..., n] arrays -------------------

    def _ifft2(re, im):
        r0, r1 = re[..., 0], re[..., 1]
        i0, i1 = im[..., 0], im[..., 1]
        return (jnp.stack([r0 + r1, r0 - r1], -1),
                jnp.stack([i0 + i1, i0 - i1], -1))

    def _ifft4(re, im):
        b = lambda a, k: a[..., k]
        tmp1 = b(re, 0) + b(re, 1)
        tmp2 = b(re, 3) + b(re, 2)
        tmp3 = b(im, 0) + b(im, 1)
        tmp4 = b(im, 2) + b(im, 3)
        tmp5 = b(re, 0) - b(re, 1)
        tmp6 = b(im, 0) - b(im, 1)
        tmp7 = b(im, 2) - b(im, 3)
        tmp8 = b(re, 3) - b(re, 2)
        re = jnp.stack([tmp1 + tmp2, tmp5 + tmp7, tmp1 - tmp2, tmp5 - tmp7],
                       -1)
        im = jnp.stack([tmp3 + tmp4, tmp6 + tmp8, tmp3 - tmp4, tmp6 - tmp8],
                       -1)
        return re, im

    def _bf_zero(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i):
        tmp1 = a2r + a3r
        tmp2 = a2i + a3i
        tmp3 = a2i - a3i
        tmp4 = a3r - a2r
        return (a0r + tmp1, a0i + tmp2, a1r + tmp3, a1i + tmp4,
                a0r - tmp1, a0i - tmp2, a1r - tmp3, a1i - tmp4)

    def _bf_half(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, w):
        tmp5 = _m((a2r + a2i), w)
        tmp6 = _m((a2i - a2r), w)
        tmp7 = _m((a3r - a3i), w)
        tmp8 = _m((a3i + a3r), w)
        tmp1 = tmp5 + tmp7
        tmp2 = tmp6 + tmp8
        tmp3 = tmp6 - tmp8
        tmp4 = tmp7 - tmp5
        return (a0r + tmp1, a0i + tmp2, a1r + tmp3, a1i + tmp4,
                a0r - tmp1, a0i - tmp2, a1r - tmp3, a1i - tmp4)

    def _bf(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, wr, wi):
        tmp5 = _m(wi, a2i) + _m(wr, a2r)
        tmp6 = _m(wr, a2i) - _m(wi, a2r)
        tmp8 = _m(wi, a3r) + _m(wr, a3i)
        tmp7 = _m(wr, a3r) - _m(wi, a3i)
        tmp1 = tmp5 + tmp7
        tmp2 = tmp6 + tmp8
        tmp3 = tmp6 - tmp8
        tmp4 = tmp7 - tmp5
        return (a0r + tmp1, a0i + tmp2, a1r + tmp3, a1i + tmp4,
                a0r - tmp1, a0i - tmp2, a1r - tmp3, a1i - tmp4)

    def _ifft8(re, im):
        r0, i0 = _ifft4(re[..., :4], im[..., :4])
        r1, i1 = _ifft2(re[..., 4:6], im[..., 4:6])
        r2, i2 = _ifft2(re[..., 6:8], im[..., 6:8])
        roots16 = _tw()["roots16"]
        a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i = _bf_zero(
            r0[..., 0], i0[..., 0], r0[..., 2], i0[..., 2],
            r1[..., 0], i1[..., 0], r2[..., 0], i2[..., 0])
        b0r, b0i, b1r, b1i, b2r, b2i, b3r, b3i = _bf_half(
            r0[..., 1], i0[..., 1], r0[..., 3], i0[..., 3],
            r1[..., 1], i1[..., 1], r2[..., 1], i2[..., 1], roots16[1])
        re = jnp.stack([a0r, b0r, a1r, b1r, a2r, b2r, a3r, b3r], -1)
        im = jnp.stack([a0i, b0i, a1i, b1i, a2i, b2i, a3i, b3i], -1)
        return re, im

    # identity weight for the widened pass: 1.0 (float) or Q30 one
    # (fixed -- FixedOps::MUL(1<<30, x) == x exactly, same split-16
    # algebra as the C macro)
    _one = 1.0 if variant == "float" else (1 << 30)

    def _ifft_pass(re, im, roots, n):
        """ifft_pass(buf, weight, n): 4 sub-buffers of length n at 0, n,
        2n, 3n.  The C code special-cases butterfly 0 (_bf_zero); here it
        rides the SAME wide _bf with wr=1, wi=0, which reproduces
        _bf_zero's formulas value-for-value: _m(0,x) = +-0 and
        _m(1,x) = x are exact, t5 = 0 + a2r rounds to a2r, and
        t1 = t5 + t7 is then fl(a2r + a3r) -- the _bf_zero op sequence
        (only zero SIGNS can differ, invisible downstream).  One wide
        butterfly per pass, no per-column concats -- ~2x fewer XLA
        materializations on the hot exact path."""
        a0r, a0i = re[..., 0:n], im[..., 0:n]
        a1r, a1i = re[..., n:2 * n], im[..., n:2 * n]
        a2r, a2i = re[..., 2 * n:3 * n], im[..., 2 * n:3 * n]
        a3r, a3i = re[..., 3 * n:4 * n], im[..., 3 * n:4 * n]

        wr = np.concatenate([[np.asarray(roots).dtype.type(_one)],
                             roots[: n - 1]])
        wi = np.concatenate([[np.asarray(roots).dtype.type(0)],
                             roots[n - 2::-1]])
        v = _bf(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, wr, wi)
        re = jnp.concatenate([v[0], v[2], v[4], v[6]], axis=-1)
        im = jnp.concatenate([v[1], v[3], v[5], v[7]], axis=-1)
        return re, im

    def _ifft16(re, im):
        r0, i0 = _ifft8(re[..., :8], im[..., :8])
        r1, i1 = _ifft4(re[..., 8:12], im[..., 8:12])
        r2, i2 = _ifft4(re[..., 12:16], im[..., 12:16])
        re = jnp.concatenate([r0, r1, r2], -1)
        im = jnp.concatenate([i0, i1, i2], -1)
        return _ifft_pass(re, im, _tw()["roots16"], 4)

    def _ifft32(re, im):
        r0, i0 = _ifft16(re[..., :16], im[..., :16])
        r1, i1 = _ifft8(re[..., 16:24], im[..., 16:24])
        r2, i2 = _ifft8(re[..., 24:32], im[..., 24:32])
        re = jnp.concatenate([r0, r1, r2], -1)
        im = jnp.concatenate([i0, i1, i2], -1)
        return _ifft_pass(re, im, _tw()["roots32"], 8)

    def _ifft64(re, im):
        r0, i0 = _ifft32(re[..., :32], im[..., :32])
        r1, i1 = _ifft16(re[..., 32:48], im[..., 32:48])
        r2, i2 = _ifft16(re[..., 48:64], im[..., 48:64])
        re = jnp.concatenate([r0, r1, r2], -1)
        im = jnp.concatenate([i0, i1, i2], -1)
        return _ifft_pass(re, im, _tw()["roots64"], 16)

    def _ifft128(re, im):
        r, i = _ifft64(re[..., :64], im[..., :64])
        r1, i1 = _ifft32(re[..., 64:96], im[..., 64:96])
        r2, i2 = _ifft32(re[..., 96:128], im[..., 96:128])
        re = jnp.concatenate([r, r1, r2], -1)
        im = jnp.concatenate([i, i1, i2], -1)
        return _ifft_pass(re, im, _tw()["roots128"], 32)

    def imdct512(data, delay, bias):
        """data [..., 256], delay [..., 128] -> (out [..., 256],
        dnew [..., 128]); exact replay of a52_imdct_512 (imdct.c:258-293)."""
        tw = _tw()
        order = tw["fftorder"]
        dk = data[..., order]
        dm = data[..., 255 - order]
        tr, ti = tw["pre1_r"], tw["pre1_i"]
        bre = _m(ti, dm) + _m(tr, dk)
        bim = _m(tr, dm) - _m(ti, dk)
        bre, bim = _ifft128(bre, bim)

        i = np.arange(64)
        t_r, t_i = tw["post1_r"], tw["post1_i"]
        fr, fi = bre[..., :64], bim[..., :64]
        gr, gi = bre[..., 127 - i], bim[..., 127 - i]
        a_r = _m(t_r, fr) + _m(t_i, fi)
        a_i = _m(t_i, fr) - _m(t_r, fi)
        b_r = _m(t_i, gr) + _m(t_r, gi)
        b_i = _m(t_r, gr) - _m(t_i, gi)

        w = tw["window"]
        d_even = delay[..., 2 * i]
        d_odd = delay[..., 2 * i + 1]
        out = jnp.zeros(data.shape[:-1] + (256,), data.dtype)
        out = out.at[..., 255 - 2 * i].set(
            (_m(d_even, w[2 * i]) + _m(a_r, w[255 - 2 * i])) + bias)
        out = out.at[..., 2 * i].set(
            (_m(d_even, w[255 - 2 * i]) - _m(a_r, w[2 * i])) + bias)
        out = out.at[..., 2 * i + 1].set(
            (_m(d_odd, w[254 - 2 * i]) + _m(b_r, w[2 * i + 1])) + bias)
        out = out.at[..., 254 - 2 * i].set(
            (_m(d_odd, w[2 * i + 1]) - _m(b_r, w[254 - 2 * i])) + bias)
        dnew = jnp.zeros(data.shape[:-1] + (128,), data.dtype)
        dnew = dnew.at[..., 2 * i].set(a_i)
        dnew = dnew.at[..., 2 * i + 1].set(b_i)
        return out, dnew

    def imdct256(data, delay, bias):
        """Exact replay of a52_imdct_256 (imdct.c:295-345)."""
        tw = _tw()
        k = tw["fftorder"][:64]
        tr, ti = tw["pre2_r"], tw["pre2_i"]
        d1a, d1b = data[..., k], data[..., 254 - k]
        d2a, d2b = data[..., k + 1], data[..., 255 - k]
        b1r = _m(ti, d1b) + _m(tr, d1a)
        b1i = _m(tr, d1b) - _m(ti, d1a)
        b2r = _m(ti, d2b) + _m(tr, d2a)
        b2i = _m(tr, d2b) - _m(ti, d2a)
        b1r, b1i = _ifft64(b1r, b1i)
        b2r, b2i = _ifft64(b2r, b2i)

        i = np.arange(32)
        t_r, t_i = tw["post2_r"], tw["post2_i"]
        a_r = _m(t_r, b1r[..., :32]) + _m(t_i, b1i[..., :32])
        a_i = _m(t_i, b1r[..., :32]) - _m(t_r, b1i[..., :32])
        g1r, g1i = b1r[..., 63 - i], b1i[..., 63 - i]
        b_r = _m(t_i, g1r) + _m(t_r, g1i)
        b_i = _m(t_r, g1r) - _m(t_i, g1i)
        c_r = _m(t_r, b2r[..., :32]) + _m(t_i, b2i[..., :32])
        c_i = _m(t_i, b2r[..., :32]) - _m(t_r, b2i[..., :32])
        g2r, g2i = b2r[..., 63 - i], b2i[..., 63 - i]
        d_r = _m(t_i, g2r) + _m(t_r, g2i)
        d_i = _m(t_r, g2r) - _m(t_i, g2i)

        w = tw["window"]
        out = jnp.zeros(data.shape[:-1] + (256,), data.dtype)
        dnew = jnp.zeros(data.shape[:-1] + (128,), data.dtype)
        d0 = delay[..., 2 * i]
        out = out.at[..., 255 - 2 * i].set((_m(d0, w[2 * i])
                                            + _m(a_r, w[255 - 2 * i])) + bias)
        out = out.at[..., 2 * i].set((_m(d0, w[255 - 2 * i])
                                      - _m(a_r, w[2 * i])) + bias)
        dnew = dnew.at[..., 2 * i].set(c_i)
        d1 = delay[..., 127 - 2 * i]
        out = out.at[..., 128 + 2 * i].set((_m(d1, w[127 - 2 * i])
                                            + _m(a_i, w[128 + 2 * i])) + bias)
        out = out.at[..., 127 - 2 * i].set((_m(d1, w[128 + 2 * i])
                                            - _m(a_i, w[127 - 2 * i])) + bias)
        dnew = dnew.at[..., 127 - 2 * i].set(c_r)
        d2 = delay[..., 2 * i + 1]
        out = out.at[..., 254 - 2 * i].set((_m(d2, w[2 * i + 1])
                                            + _m(b_i, w[254 - 2 * i])) + bias)
        out = out.at[..., 2 * i + 1].set((_m(d2, w[254 - 2 * i])
                                          - _m(b_i, w[2 * i + 1])) + bias)
        dnew = dnew.at[..., 2 * i + 1].set(d_r)
        d3 = delay[..., 126 - 2 * i]
        out = out.at[..., 129 + 2 * i].set((_m(d3, w[126 - 2 * i])
                                            + _m(b_r, w[129 + 2 * i])) + bias)
        out = out.at[..., 126 - 2 * i].set((_m(d3, w[129 + 2 * i])
                                            - _m(b_r, w[126 - 2 * i])) + bias)
        dnew = dnew.at[..., 126 - 2 * i].set(d_i)
        return out, dnew

    def filterbank(coeffs, delay, blksw, bias):
        """Drop-in for ops.filterbank.filterbank with bit-exact semantics."""
        out_l, d_l = imdct512(coeffs, delay, bias[..., None])
        out_s, d_s = imdct256(coeffs, delay, bias[..., None])
        blk = blksw[..., None]
        return jnp.where(blk, out_s, out_l), jnp.where(blk, d_s, d_l)

    # exact permutation matmuls (float only) --------------------------------
    #
    # Static lane permutations as matmuls against {0,+-1} matrices instead
    # of take/scatter: written for a compiler whose gather lowering was
    # slow at batch shapes; on the GPU the two forms have not been timed
    # against each other (ROADMAP A5).  A
    # {0,+-1} matrix at Precision.HIGHEST is BITWISE exact: the operand
    # decomposes into bf16 limbs of disjoint significand bits (an exact
    # real decomposition), each limb times 0/+-1 is exact, and summing
    # disjoint-bit limbs reconstructs the float exactly.  Verified by
    # array_equal against the take/scatter forms in tests.
    def _permute_dot(x, mat_np):
        return jnp.matmul(x, jnp.asarray(mat_np),
                          precision=jax.lax.Precision.HIGHEST)

    @lru_cache(maxsize=1)
    def _perm_mats_512():
        tw = _tw_float()
        order = np.asarray(tw["fftorder"])
        i = np.arange(64)
        k = np.arange(128)
        pre = np.zeros((256, 256), np.float32)     # -> [dk | dm]
        pre[order, k] = 1.0
        pre[255 - order, 128 + k] = 1.0
        pz = np.zeros((128, 256), np.float32)      # [a_r | b_r] -> z
        pz[i, 255 - 2 * i] = 1.0
        pz[i, 2 * i] = -1.0
        pz[64 + i, 2 * i + 1] = 1.0
        pz[64 + i, 254 - 2 * i] = -1.0
        pd = np.zeros((128, 128), np.float32)      # [a_i | b_i] -> dnew
        pd[i, 2 * i] = 1.0
        pd[64 + i, 2 * i + 1] = 1.0
        return pre, pz, pd

    @lru_cache(maxsize=1)
    def _perm_mats_256():
        tw = _tw_float()
        kk = np.asarray(tw["fftorder"][:64])
        i = np.arange(32)
        c = np.arange(64)
        pre = np.zeros((256, 256), np.float32)     # -> [d1a|d1b|d2a|d2b]
        pre[kk, c] = 1.0
        pre[254 - kk, 64 + c] = 1.0
        pre[kk + 1, 128 + c] = 1.0
        pre[255 - kk, 192 + c] = 1.0
        pz = np.zeros((128, 256), np.float32)      # [a_r|a_i|b_r|b_i] -> z
        pz[i, 255 - 2 * i] = 1.0
        pz[i, 2 * i] = -1.0
        pz[32 + i, 128 + 2 * i] = 1.0
        pz[32 + i, 127 - 2 * i] = -1.0
        pz[64 + i, 129 + 2 * i] = 1.0
        pz[64 + i, 126 - 2 * i] = -1.0
        pz[96 + i, 254 - 2 * i] = 1.0
        pz[96 + i, 2 * i + 1] = -1.0
        pd = np.zeros((128, 128), np.float32)      # [c_r|c_i|d_r|d_i] -> dnew
        pd[i, 127 - 2 * i] = 1.0
        pd[32 + i, 2 * i] = 1.0
        pd[64 + i, 2 * i + 1] = 1.0
        pd[96 + i, 126 - 2 * i] = 1.0
        return pre, pz, pd

    # (z, d) split form -- float only ---------------------------------------
    #
    # The windowed OLA epilogue shared by the hoisted pipelines
    # (models.decoder's `ola`: z*win + fold(delay)*win_r + bias) is
    # bit-identical to the reference's per-sample formulas when z carries
    # the post-twiddle outputs at their scatter positions WITH the
    # subtraction folded in as a sign flip:
    #
    #   out[255-2i] = (d[2i]*w[2i]      + a_r*w[255-2i]) + bias
    #   out[2i]     = (d[2i]*w[255-2i]  - a_r*w[2i])     + bias
    #
    # maps to z[255-2i] = a_r, z[2i] = -a_r (and the b_r pair likewise):
    # IEEE float negation commutes exactly through multiplication
    # (fl(-a*w) == -fl(a*w)), the two products are the reference's own,
    # and a+b == b+a bitwise.  The delay factor positions line up because
    # fold(delay)[k] = delay[k] for k < 128 and delay[255-k] above, with
    # win_r[k] = w[255-k].  NOT valid for the fixed variant: FixedOps::MUL
    # truncates toward -inf, so negation does not commute -- the fixed
    # paths keep the direct imdct512/imdct256 forms.
    def imdct512_z(data):
        """data [..., 256] -> (z [..., 256], dnew [..., 128]): the exact
        a52_imdct_512 split so that the hoisted `ola` epilogue reproduces
        the reference output bit for bit.  dnew is independent of the
        entering delay, which is what makes scan-free chunk pipelines
        possible with exact numerics.  Lane permutations ride exact
        HIGHEST matmuls (see _permute_dot above)."""
        tw = _tw()
        pre, pz, pd = _perm_mats_512()
        g = _permute_dot(data, pre)
        dk, dm = g[..., :128], g[..., 128:]
        tr, ti = tw["pre1_r"], tw["pre1_i"]
        bre = _m(ti, dm) + _m(tr, dk)
        bim = _m(tr, dm) - _m(ti, dk)
        bre, bim = _ifft128(bre, bim)

        i = np.arange(64)
        t_r, t_i = tw["post1_r"], tw["post1_i"]
        fr, fi = bre[..., :64], bim[..., :64]
        gr = jnp.flip(bre[..., 64:], axis=-1)
        gi = jnp.flip(bim[..., 64:], axis=-1)
        a_r = _m(t_r, fr) + _m(t_i, fi)
        a_i = _m(t_i, fr) - _m(t_r, fi)
        b_r = _m(t_i, gr) + _m(t_r, gi)
        b_i = _m(t_r, gr) - _m(t_i, gi)
        z = _permute_dot(jnp.concatenate([a_r, b_r], axis=-1), pz)
        dnew = _permute_dot(jnp.concatenate([a_i, b_i], axis=-1), pd)
        return z, dnew

    def imdct256_z(data):
        """Short-block twin of imdct512_z (a52_imdct_256)."""
        tw = _tw()
        pre, pz, pd = _perm_mats_256()
        g = _permute_dot(data, pre)
        d1a, d1b = g[..., :64], g[..., 64:128]
        d2a, d2b = g[..., 128:192], g[..., 192:]
        tr, ti = tw["pre2_r"], tw["pre2_i"]
        b1r = _m(ti, d1b) + _m(tr, d1a)
        b1i = _m(tr, d1b) - _m(ti, d1a)
        b2r = _m(ti, d2b) + _m(tr, d2a)
        b2i = _m(tr, d2b) - _m(ti, d2a)
        b1r, b1i = _ifft64(b1r, b1i)
        b2r, b2i = _ifft64(b2r, b2i)

        t_r, t_i = tw["post2_r"], tw["post2_i"]
        a_r = _m(t_r, b1r[..., :32]) + _m(t_i, b1i[..., :32])
        a_i = _m(t_i, b1r[..., :32]) - _m(t_r, b1i[..., :32])
        g1r = jnp.flip(b1r[..., 32:], axis=-1)
        g1i = jnp.flip(b1i[..., 32:], axis=-1)
        b_r = _m(t_i, g1r) + _m(t_r, g1i)
        b_i = _m(t_r, g1r) - _m(t_i, g1i)
        c_r = _m(t_r, b2r[..., :32]) + _m(t_i, b2i[..., :32])
        c_i = _m(t_i, b2r[..., :32]) - _m(t_r, b2i[..., :32])
        g2r = jnp.flip(b2r[..., 32:], axis=-1)
        g2i = jnp.flip(b2i[..., 32:], axis=-1)
        d_r = _m(t_i, g2r) + _m(t_r, g2i)
        d_i = _m(t_r, g2r) - _m(t_i, g2i)

        z = _permute_dot(
            jnp.concatenate([a_r, a_i, b_r, b_i], axis=-1), pz)
        dnew = _permute_dot(
            jnp.concatenate([c_r, c_i, d_r, d_i], axis=-1), pd)
        return z, dnew

    out = {"imdct512": imdct512, "imdct256": imdct256,
           "filterbank": filterbank}
    if variant == "float":
        out["imdct512_z"] = imdct512_z
        out["imdct256_z"] = imdct256_z
    return out


def get_variant(variant: str):
    """{'imdct512', 'imdct256', 'filterbank'} for 'float' or 'fixed'."""
    assert variant in ("float", "fixed")
    return _build(variant)


# float public API (backwards compatible) -----------------------------------

def imdct512_exact(data, delay, bias):
    return _build("float")["imdct512"](data, delay, bias)


def imdct256_exact(data, delay, bias):
    return _build("float")["imdct256"](data, delay, bias)


def filterbank_exact(coeffs, delay, blksw, bias):
    return _build("float")["filterbank"](coeffs, delay, blksw, bias)


def split_fb_exact(coeffs, blksw=None):
    """(z, dnew) split filterbank for the hoisted chunk pipelines: feed z
    through the shared `ola` epilogue (models.decoder) and the output is
    bit-identical to the reference float build.  blksw=None skips the
    short-block transform entirely (long-only chunks)."""
    b = _build("float")
    z_l, d_l = b["imdct512_z"](coeffs)
    if blksw is None:
        return z_l, d_l
    z_s, d_s = b["imdct256_z"](coeffs)
    blk = blksw[..., None]
    return jnp.where(blk, z_s, z_l), jnp.where(blk, d_s, d_l)
