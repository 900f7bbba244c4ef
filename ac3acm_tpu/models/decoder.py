"""AC-3 decoder: the device pipelines and the per-stream Decoder.

Split of responsibilities (BASELINE north star):
  host pre-pass (ac3acm_tpu.host.parse)  -> dense (q, a, b) block tensors
  device pipeline (here, jit/scan/vmap)  -> PCM

The device pipeline reproduces a52_block's math stage-for-stage
(parse.c:558-940): dequant `(q*a)*b`, stereo rematrixing, the
downmix-before-IMDCT vs IMDCT-then-downmix strategy decision (including the
`downmixed` delay-layout carry and its upmix/downmix fixups,
parse.c:881-937), the 128-float OLA delay per channel, and the exact mixer
orderings from downmix.c.  It is jit-specialized on the stream format
(acmod, output mode, LFE, slev==0) -- the production design buckets streams
by format.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables as T
from ..host import parse as P
from ..ops.downmix import downmix, upmix
from ..ops.filterbank import filterbank

# ---------------------------------------------------------------------------
# Package-wide decode accuracy policy.
#
#   "reference" (default): every decode path replays the reference's IMDCT
#       operation order (ops.imdct_exact) -- output is bit-identical to the
#       compiled float liba52 on any backend, so the compare.c contract
#       (max <= 0.01, mean <= 0.001, sigma <= 0.001 in 1/32768 units;
#       a52dec-0.7.5-cvs/test/compare.c:63-72) holds by construction on ALL
#       content, not just measured content.
#   "fast": the HIGHEST-precision matmul filterbank.  Contract:
#       max <= 0.02, mean <= 0.001, sigma <= 0.002 --
#       the dot-product reassociation error is a few f32 ulps of the
#       partial sums, which adversarial full-scale content can push past
#       compare.c's 0.01 (measured 0.25 LSB on a coupling-dense stream)
#       while real program material measures <= 0.006.
#
# Resolved at pipeline BUILD time: flip it before constructing decoders /
# dispatching batched pipelines (set_accuracy), not mid-stream.
ACCURACY = "reference"


def set_accuracy(mode: str):
    """Set the package decode accuracy policy ("reference" | "fast")."""
    global ACCURACY
    assert mode in ("reference", "fast"), mode
    ACCURACY = mode


def default_exact() -> bool:
    return ACCURACY == "reference"


@dataclass(frozen=True)
class StreamFormat:
    """Static jit-specialization key for the device pipeline."""
    acmod: int
    output: int          # negotiated output incl. A52_LFE bit
    slev_zero: bool
    chanbias: int

    @property
    def nfchans(self) -> int:
        return int(T.NFCHANS[self.acmod])

    @property
    def nf_out(self) -> int:
        return int(T.NFCHANS[self.output & T.A52_CHANNEL_MASK])

    @property
    def lfe_out(self) -> bool:
        return bool(self.output & T.A52_LFE)

    @property
    def nch_out(self) -> int:
        return self.nf_out + (1 if self.lfe_out else 0)

    @property
    def identity_mix(self) -> bool:
        """True when the time-domain mixer is a no-op for this format
        (the identity pairs of downmix.c:480-619: output mode == acmod, or
        STEREO->DOLBY) and no channel takes its bias from the mix
        (chanbias == 0).  Such passthrough decodes qualify for the
        premixed fast path too: the host premix is rematrix-only and
        ships nfchans (+LFE) planes instead of all 6."""
        out = self.output & T.A52_CHANNEL_MASK
        if self.nf_out != self.nfchans or self.chanbias != 0:
            return False
        return out == self.acmod or (self.acmod == T.A52_STEREO
                                     and out == T.A52_DOLBY)


def _block_step(fmt: StreamFormat, carry, blk, filterbank=filterbank):
    """One a52_block worth of device math.  carry = (delay [6,128], downmixed).

    blk: dict with q,a,b [6,256]; blksw [5] bool; coeff [5]; remat [256] bool;
    bias scalar.  `filterbank` may be swapped for the order-exact variant
    (ops.imdct_exact.filterbank_exact) to reproduce the reference's float
    output bit-for-bit.
    """
    delay, downmixed = carry
    nf = fmt.nfchans
    bias = blk["bias"]

    freq = blk["freq"]                               # [6, 256] (host dequant)

    if fmt.acmod == T.A52_STEREO:
        s0, s1 = freq[0], freq[1]
        m = blk["remat"]
        freq = freq.at[0].set(jnp.where(m, s0 + s1, s0))
        freq = freq.at[1].set(jnp.where(m, s0 - s1, s1))

    # --- LFE (always long block, always state->bias) ------------------------
    lfe_time = None
    new_delay = delay
    if fmt.lfe_out:
        lfe_time, lfe_d = filterbank(freq[5], delay[5], jnp.asarray(False), bias)
        new_delay = new_delay.at[5].set(lfe_d)

    fbw = freq[:5]
    blksw = blk["blksw"]
    coeff = blk["coeff"]

    # --- TIME path: IMDCT coded channels, then time-domain downmix ----------
    delay_t = jnp.where(downmixed, upmix(delay[:5], fmt.acmod, fmt.output),
                        delay[:5])
    bias_vec = jnp.where(
        jnp.asarray([(fmt.chanbias >> i) & 1 for i in range(5)], bool),
        jnp.zeros_like(bias), bias)
    t_out, t_dnew = filterbank(fbw, delay_t, blksw, bias_vec)
    zero_ch = (coeff == 0.0)[:, None]
    t_out = jnp.where(zero_ch, bias, t_out)
    t_dnew = jnp.where(zero_ch, delay_t, t_dnew)
    t_mixed = downmix(t_out, fmt.acmod, fmt.output, bias,
                      slev_zero=fmt.slev_zero)

    if fmt.nf_out >= fmt.nfchans:
        # reference always takes the TIME path here (parse.c:881-886)
        out = t_mixed
        new_delay = new_delay.at[:5].set(t_dnew)
        carry = (new_delay, jnp.asarray(False))
    else:
        # --- FREQ path: downmix in frequency domain, IMDCT output channels --
        f_freq = downmix(fbw, fmt.acmod, fmt.output, jnp.asarray(0.0, fbw.dtype),
                         slev_zero=fmt.slev_zero)
        delay_f = jnp.where(downmixed, delay[:5],
                            downmix(delay[:5], fmt.acmod, fmt.output,
                                    jnp.asarray(0.0, fbw.dtype),
                                    slev_zero=fmt.slev_zero))
        blk0 = jnp.broadcast_to(blksw[0], (5,))
        f_out, f_dnew = filterbank(f_freq, delay_f, blk0,
                                   jnp.broadcast_to(bias, (5,)))
        uniform = jnp.all(blksw[:nf] == blksw[0])
        out = jnp.where(uniform, f_out, t_mixed)
        new_delay = new_delay.at[:5].set(jnp.where(uniform, f_dnew, t_dnew))
        carry = (new_delay, uniform)

    planes = [out[i] for i in range(fmt.nf_out)]
    if fmt.lfe_out:
        planes = [lfe_time] + planes
    pcm = jnp.stack(planes)                          # [nch_out, 256]
    return carry, pcm


def _pipeline_body(fmt: StreamFormat, carry, blocks, exact: bool = False):
    """All blocks of a chunk at once: the filterbank matmuls are hoisted out
    of the sequential part (the OLA carry only feeds the cheap window
    epilogue), so blocks x channels x streams fuse into one matmul and
    the scan body is elementwise.  Equivalent to scanning _block_step
    (guarded by tests).  exact=True hoists the order-exact (z, d) split
    instead of the matmul (see _pipeline_steady)."""
    from ..ops.filterbank import _mats, HIGHEST

    w_long, w_short, win = _mats()
    win_r = win[::-1].copy()
    nf = fmt.nfchans
    reduces = fmt.nf_out < fmt.nfchans

    if exact:
        from ..ops.imdct_exact import split_fb_exact, _mul_float
        split_fb = split_fb_exact

        # separate product rounding -- see _pipeline_steady's exact ola
        def ola(z, delay, bias):
            dfold = jnp.concatenate([delay, delay[..., ::-1]], axis=-1)
            return (_mul_float(z, jnp.asarray(win))
                    + _mul_float(dfold, jnp.asarray(win_r)) + bias)
    else:
        def split_fb(coeffs, blksw):
            blk = blksw[..., None]
            c_long = jnp.where(blk, 0.0, coeffs)
            c_short = jnp.where(blk, coeffs, 0.0)
            zd = (jnp.matmul(c_long, jnp.asarray(w_long), precision=HIGHEST)
                  + jnp.matmul(c_short, jnp.asarray(w_short),
                               precision=HIGHEST))
            return zd[..., :256], zd[..., 256:]

        def ola(z, delay, bias):
            dfold = jnp.concatenate([delay, delay[..., ::-1]], axis=-1)
            return z * jnp.asarray(win) + dfold * jnp.asarray(win_r) + bias

    freq = blocks["freq"]                                # [n, 6, 256]
    if fmt.acmod == T.A52_STEREO:
        s0, s1 = freq[:, 0], freq[:, 1]
        m = blocks["remat"]
        freq = freq.at[:, 0].set(jnp.where(m, s0 + s1, s0))
        freq = freq.at[:, 1].set(jnp.where(m, s0 - s1, s1))

    blksw = blocks["blksw"]                              # [n, 5]
    coeff = blocks["coeff"]
    bias = blocks["bias"]                                # [n]
    fbw = freq[:, :5]

    z_t, d_t = split_fb(fbw, blksw)
    per = dict(z_t=z_t, d_t=d_t, blksw=blksw, coeff=coeff, bias=bias)
    if reduces:
        zero = jnp.zeros((), freq.dtype)
        f_freq = jax.vmap(lambda p: downmix(p, fmt.acmod, fmt.output, zero,
                                            slev_zero=fmt.slev_zero))(fbw)
        # only the nf_out output channels are transformed on this path
        # (parse.c:918-936); upper delay planes stay stale, and every
        # upmix case only reads/zeroes them, never consumes them
        f_freq = f_freq[:, : fmt.nf_out]
        blk0 = jnp.broadcast_to(blksw[:, :1], (blksw.shape[0], fmt.nf_out))
        z_f, d_f = split_fb(f_freq, blk0)
        per.update(z_f=z_f, d_f=d_f)
    if fmt.lfe_out:
        z_l, d_l = split_fb(freq[:, 5], jnp.zeros(freq.shape[0], bool))
        per.update(z_l=z_l, d_l=d_l)

    bias_mask = jnp.asarray([(fmt.chanbias >> i) & 1 for i in range(5)], bool)

    def step(c, p):
        delay, downmixed = c
        b = p["bias"]
        new_delay = delay
        outs = []
        if fmt.lfe_out:
            lfe = ola(p["z_l"], delay[5], b)
            new_delay = new_delay.at[5].set(p["d_l"])
            outs.append(lfe[None])
        bias_vec = jnp.where(bias_mask, 0.0, b)[:, None]
        delay_t = jnp.where(downmixed, upmix(delay[:5], fmt.acmod, fmt.output),
                            delay[:5])
        t_out = ola(p["z_t"], delay_t, bias_vec)
        zero_ch = (p["coeff"] == 0.0)[:, None]
        t_out = jnp.where(zero_ch, b, t_out)
        t_dnew = jnp.where(zero_ch, delay_t, p["d_t"])
        t_mixed = downmix(t_out, fmt.acmod, fmt.output, b,
                          slev_zero=fmt.slev_zero)
        if not reduces:
            out = t_mixed
            new_delay = new_delay.at[:5].set(t_dnew)
            c = (new_delay, jnp.zeros((), bool))
        else:
            zero = jnp.zeros((), t_out.dtype)
            delay_f = jnp.where(downmixed, delay[:5],
                                downmix(delay[:5], fmt.acmod, fmt.output,
                                        zero, slev_zero=fmt.slev_zero))
            nfo = fmt.nf_out
            f_out = ola(p["z_f"], delay_f[:nfo], b)
            uniform = jnp.all(p["blksw"][:nf] == p["blksw"][0])
            out = jnp.where(uniform, f_out, t_mixed[:nfo])
            d_f_full = jnp.concatenate([p["d_f"], delay_f[nfo:]], axis=0)
            new_delay = new_delay.at[:5].set(
                jnp.where(uniform, d_f_full, t_dnew))
            c = (new_delay, uniform)
            pcm = jnp.concatenate(outs + [out], axis=0) if outs else out
            return c, pcm
        pcm = jnp.concatenate(outs + [out[: fmt.nf_out]], axis=0) \
            if outs else out[: fmt.nf_out]
        return c, pcm

    return jax.lax.scan(step, carry, per)


def _pipeline_steady(fmt: StreamFormat, carry, blocks,
                     long_only: bool = False, premixed: bool = False,
                     exact: bool = False):
    """Scan-free fast path: when every block takes the same strategy, the
    OLA delay chain is a pure one-block shift (delay[b+1] = d[b]), so the
    whole chunk is elementwise after the hoisted matmuls.

    Validity (checked on the host by `steady_ok`, dispatched per call):
      * reduces (freq path): blksw uniform across coded channels in every
        block -- the path never flips to time-domain;
      * passthrough (time path): no zero-coeff channel (the reference skips
        the IMDCT there and KEEPS the old delay, a real recurrence).
    The entry-state fixups (upmix/downmix of the carried delay) are applied
    once, exactly as the scan's first step would.

    long_only=True (requires no short block anywhere in the chunk --
    host-checked) skips the all-zero short-matrix matmul, halving the
    dominant matmul cost.  Identical values: zeros @ w_short contributes
    exact zeros.

    exact=True (the ACCURACY="reference" default) swaps the matmul
    for the order-exact (z, d) split (ops.imdct_exact.split_fb_exact):
    the chunk structure is unchanged -- the exact IMDCT's delay output is
    also independent of the entering delay -- and the output becomes
    bit-identical to the reference float build.
    """
    from ..ops.filterbank import _mats, HIGHEST

    w_long, w_short, win = _mats()
    win_r = win[::-1].copy()
    reduces = fmt.nf_out < fmt.nfchans

    if exact:
        from ..ops.imdct_exact import split_fb_exact, _mul_float

        def split_fb(coeffs, blksw):
            return split_fb_exact(coeffs, None if long_only else blksw)

        # the OLA products must round separately (the reference multiplies
        # then adds); plain f32 mul+add lets XLA FMA-contract, skipping
        # the product rounding -- same guard as ops.imdct_exact
        def ola(z, delay, bias):
            dfold = jnp.concatenate([delay, delay[..., ::-1]], axis=-1)
            return (_mul_float(z, jnp.asarray(win))
                    + _mul_float(dfold, jnp.asarray(win_r)) + bias)
    else:
        def split_fb(coeffs, blksw):
            if long_only:
                zd = jnp.matmul(coeffs, jnp.asarray(w_long),
                                precision=HIGHEST)
                return zd[..., :256], zd[..., 256:]
            blk = blksw[..., None]
            c_long = jnp.where(blk, 0.0, coeffs)
            c_short = jnp.where(blk, coeffs, 0.0)
            zd = (jnp.matmul(c_long, jnp.asarray(w_long), precision=HIGHEST)
                  + jnp.matmul(c_short, jnp.asarray(w_short),
                               precision=HIGHEST))
            return zd[..., :256], zd[..., 256:]

        def ola(z, delay, bias):
            dfold = jnp.concatenate([delay, delay[..., ::-1]], axis=-1)
            return z * jnp.asarray(win) + dfold * jnp.asarray(win_r) + bias

    def chain(d, d0):
        # delay seen by block b is block b-1's output delay; b=0 sees carry
        return jnp.concatenate([d0[None], d[:-1]], axis=0)

    delay, downmixed = carry
    freq = blocks["freq"]          # [n, 6, 256]; premixed: [n, nfo(+1), 256]
    if premixed:
        assert reduces or fmt.identity_mix, \
            "premixed blocks require the freq path or an identity mix"
    if fmt.acmod == T.A52_STEREO and not premixed:
        s0, s1 = freq[:, 0], freq[:, 1]
        m = blocks["remat"]
        freq = freq.at[:, 0].set(jnp.where(m, s0 + s1, s0))
        freq = freq.at[:, 1].set(jnp.where(m, s0 - s1, s1))
    blksw = blocks["blksw"]
    bias = blocks["bias"][:, None, None]                 # [n,1,1]
    fbw = None if premixed else freq[:, :5]
    outs = []
    new_delay = delay

    if fmt.lfe_out:
        lfe_plane = freq[:, fmt.nf_out] if premixed else freq[:, 5]
        z_l, d_l = split_fb(lfe_plane, jnp.zeros(freq.shape[0], bool))
        lfe = ola(z_l, chain(d_l, delay[5]), bias[:, 0])
        new_delay = new_delay.at[5].set(d_l[-1])
        outs.append(lfe[:, None])

    if reduces:
        zero = jnp.zeros((), freq.dtype)
        if premixed:
            f_freq = freq[:, : fmt.nf_out]
        else:
            f_freq = jax.vmap(
                lambda p: downmix(p, fmt.acmod, fmt.output, zero,
                                  slev_zero=fmt.slev_zero))(fbw)
            f_freq = f_freq[:, : fmt.nf_out]
        blk0 = jnp.broadcast_to(blksw[:, :1], (blksw.shape[0], fmt.nf_out))
        z_f, d_f = split_fb(f_freq, blk0)
        # entry fixup: a carry from a time-path block holds per-channel
        # delays; downmix them once (the scan's first-step behaviour)
        d0 = jnp.where(downmixed, delay[:5],
                       downmix(delay[:5], fmt.acmod, fmt.output, zero,
                               slev_zero=fmt.slev_zero))
        out = ola(z_f, chain(d_f, d0[: fmt.nf_out]), bias)
        new_delay = new_delay.at[: fmt.nf_out].set(d_f[-1])
        # planes nf_out..4 stay stale, exactly like the scan's d_f_full
        new_delay = new_delay.at[fmt.nf_out: 5].set(d0[fmt.nf_out:])
        carry = (new_delay, jnp.ones((), bool))
    elif premixed:
        # passthrough premix (identity mix, chanbias == 0): the host
        # applied rematrixing and ships only the real planes; upmix,
        # bias masking and the output mix are all no-ops for this
        # format, and the unused upper delay planes land exactly where
        # the generic path puts them (zd of all-zero planes == 0)
        nfo = fmt.nf_out
        z_t, d_t = split_fb(freq[:, :nfo], blksw[:, :nfo])
        out = ola(z_t, chain(d_t, delay[:nfo]), bias)
        new_delay = new_delay.at[:nfo].set(d_t[-1])
        new_delay = new_delay.at[nfo:5].set(0.0)
        carry = (new_delay, jnp.zeros((), bool))
    else:
        z_t, d_t = split_fb(fbw, blksw)
        d0 = jnp.where(downmixed, upmix(delay[:5], fmt.acmod, fmt.output),
                       delay[:5])
        bias_mask = jnp.asarray([(fmt.chanbias >> i) & 1
                                 for i in range(5)], bool)
        bias_vec = jnp.where(bias_mask[None, :, None], 0.0, bias)
        t_out = ola(z_t, chain(d_t, d0), bias_vec)
        out = jax.vmap(lambda p, bb: downmix(p, fmt.acmod, fmt.output, bb,
                                             slev_zero=fmt.slev_zero))(
            t_out, blocks["bias"])[:, : fmt.nf_out]
        new_delay = new_delay.at[:5].set(d_t[-1])
        carry = (new_delay, jnp.zeros((), bool))
    pcm = jnp.concatenate(outs + [out], axis=1) if outs else out
    return carry, pcm


def premix_blocks(fmt: StreamFormat, blocks) -> dict:
    """Host-side downmix for the steady freq path: applies rematrixing and
    the mixer sums in numpy (identical IEEE f32 adds to the device) and
    ships only the nf_out (+LFE) planes -- 2-3x less host->device volume
    and pipeline input reads.  Only valid together with the steady path
    (checked by steady_ok); LFE plane, when present, comes last.

    Identity-mix passthrough formats (fmt.identity_mix, e.g. stereo->
    stereo) qualify too: the mix below is then a no-op and the premix is
    rematrix-only."""
    assert fmt.nf_out < fmt.nfchans or fmt.identity_mix, \
        "premix requires the freq (reduces) path or an identity mix"
    freq = np.asarray(blocks["freq"])                  # [..., n, 6, 256]
    if fmt.acmod == T.A52_STEREO:
        m = np.asarray(blocks["remat"])
        s0 = freq[..., 0, :]
        s1 = freq[..., 1, :]
        freq = freq.copy()
        freq[..., 0, :] = np.where(m, s0 + s1, s0)
        freq[..., 1, :] = np.where(m, s0 - s1, s1)
    planes = np.moveaxis(freq, -2, 0)                  # [6, ..., 256]
    mixed = downmix(planes[:5], fmt.acmod, fmt.output,
                    np.float32(0.0), slev_zero=fmt.slev_zero)
    keep = [np.asarray(mixed[i]) for i in range(fmt.nf_out)]
    if fmt.lfe_out:
        keep.append(np.asarray(planes[5]))
    pre = np.moveaxis(np.stack(keep), 0, -2)           # [..., n, nfo(+1), 256]
    out = dict(blocks)
    out["freq"] = np.ascontiguousarray(pre)
    return out


def steady_ok(fmt: StreamFormat, blocks) -> bool:
    """Host-side eligibility check for _pipeline_steady (numpy blocks,
    arbitrary leading batch axes)."""
    blksw = np.asarray(blocks["blksw"])
    nf = fmt.nfchans
    if fmt.nf_out < fmt.nfchans:
        return bool((blksw[..., :nf] == blksw[..., :1]).all())
    return bool((np.asarray(blocks["coeff"])[..., :nf] != 0.0).all())


@lru_cache(maxsize=64)
def steady_pipeline(fmt: StreamFormat, long_only: bool = False,
                    premixed: bool = False, exact: bool = False):
    """jitted scan-free chunk pipeline (see _pipeline_steady)."""
    return jax.jit(partial(_pipeline_steady, fmt, long_only=long_only,
                           premixed=premixed, exact=exact))


def block_pipeline(fmt: StreamFormat, exact: bool = None):
    """jitted (carry, blocks) -> (carry, pcm [nblk, nch_out, 256]).

    blocks: pytree of stacked per-block tensors with leading nblk axis.
    Batched variants vmap this over a leading stream axis.

    exact (default: the package ACCURACY policy) hoists the order-exact
    (z, d) IMDCT split (ops.imdct_exact) instead of the matmul: the
    float output then replays the reference's operation order bit-for-bit
    on any backend (the matmul path is within a few f32 ulps of the
    partial sums, which adversarial content can push past compare.c's
    0.01 threshold).
    """
    if exact is None:
        exact = default_exact()
    return _block_pipeline_cached(fmt, bool(exact))


@lru_cache(maxsize=64)
def _block_pipeline_cached(fmt: StreamFormat, exact: bool):
    return jax.jit(partial(_pipeline_body, fmt, exact=exact))


@lru_cache(maxsize=32)
def fixed_block_pipeline(fmt: StreamFormat):
    """LIBA52_FIXED device pipeline: int32 Q30 throughout.

    Same _block_step orchestration as the float scan (path decision,
    downmix/upmix carry fixups, zero-coeff channels), with the order-exact
    filterbank built over the reference's Q30 MUL semantics
    (ops/imdct_exact.get_variant('fixed'); a52_internal.h:144-150).  The
    host pre-pass (native ac3h_sdec_parse_fixed) has already dequantized
    and rematrixed, so blocks carry remat=False; bias is always 0 in the
    fixed build (BIASV, native/ac3sample.inc:48).

    blocks: freq int32 [n, 6, 256], blksw bool [n, 5], coeff f32 0/1
    validity flags [n, 5], remat False [n, 256], bias int32 zeros [n].
    carry: (delay int32 [6, 128], downmixed bool).
    """
    from ..ops.imdct_exact import get_variant
    fb = get_variant("fixed")["filterbank"]

    def run(carry, blocks):
        step = partial(_block_step, fmt, filterbank=fb)
        return jax.lax.scan(step, carry, blocks)

    return jax.jit(run)


def init_fixed_carry():
    return (jnp.zeros((6, 128), jnp.int32), jnp.asarray(True))


def init_carry(batch_shape=()):
    return (jnp.zeros(batch_shape + (6, 128), jnp.float32),
            jnp.zeros(batch_shape, bool) | True)


def _stack_blocks(frames) -> dict:
    """Stack host FrameData blocks into device arrays [nblk, ...]."""
    blocks = [b for f in frames for b in f.blocks]
    bias = np.float32(frames[0].bias)
    return {
        # host-side dequant: identical IEEE f32 multiplies to the device
        "freq": np.stack([(b.q * b.a) * b.b for b in blocks]),
        "blksw": np.stack([b.blksw for b in blocks]),
        "coeff": np.stack([b.coeff for b in blocks]),
        "remat": np.stack([b.remat_mask for b in blocks]),
        "bias": np.full(len(blocks), bias, np.float32),
    }


class Decoder:
    """Single-stream decoder with the a52_* API shape.

    >>> dec = Decoder()
    >>> pcm = dec.decode(es_bytes, flags=T.A52_STEREO | T.A52_ADJUST_LEVEL,
    ...                  level=1.0, bias=0.0)      # float32 [n, nch, 256]
    """

    def __init__(self, exact: bool = None):
        self.parser = P.A52Parser()
        self._carry = None
        self._fmt = None
        # None: follow the package ACCURACY policy (default "reference" --
        # bit-exact vs the compiled float liba52); exact=False opts into
        # the fast matmul filterbank (0.02-LSB contract)
        self._exact = default_exact() if exact is None else exact

    def syncinfo(self, buf: bytes):
        return P.syncinfo(buf)

    def dynrng(self, callback=None):
        """a52_dynrng parity (parse.c:207-216): None disables DRC; a
        callable re-enables it with fn(range) -> range remapping."""
        self.parser.s.dynrnge = callable(callback)
        if callable(callback):
            self.parser.s.dynrng_call = callback

    def set_drc_enabled(self, enabled: bool):
        self.parser.s.dynrnge = enabled

    def decode_frames(self, frames_bytes, flags, level=1.0, bias=0.0):
        """Decode a list of raw frames; returns float32 [nblk, nch_out, 256]."""
        frames = [self.parser.decode_frame(fb, flags, level, bias)
                  for fb in frames_bytes]
        # format is per frame (acmod / output / slev can change mid-stream);
        # the carry (OLA delay + downmixed flag) persists across formats,
        # exactly like the reference's single a52_state_t
        outs = []
        fmt = None
        for f in frames:
            fmt = StreamFormat(
                acmod=f.acmod, output=f.output,
                slev_zero=bool(f.slev == 0.0),
                chanbias=int(P.downmix_coeff(
                    f.acmod, f.output, 1.0,
                    np.float32(0.5), f.slev)[1]))
            if self._carry is None:
                self._carry = init_carry()
            self._fmt = fmt
            blocks = _stack_blocks([f])
            self._carry, pcm = block_pipeline(fmt, exact=self._exact)(
                self._carry, blocks)
            outs.append(np.asarray(pcm))
        return np.concatenate(outs, axis=0), fmt

    def decode_stream(self, es: bytes, flags, level=1.0, bias=0.0):
        """Frame-sync state machine over an elementary stream."""
        frames = []
        pos = 0
        while pos + 7 <= len(es):
            size, _, _, _ = P.syncinfo(es[pos:pos + 7])
            if size == 0:
                pos += 1
                continue
            if pos + size > len(es):
                break
            frames.append(es[pos:pos + size])
            pos += size
        if not frames:
            return np.zeros((0, 0, 256), np.float32), None
        return self.decode_frames(frames, flags, level, bias)
