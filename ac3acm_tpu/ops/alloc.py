"""Device-side parametric bit allocation (A/52 §7.2.2), fully vectorized.

Same algorithm as the host allocator (ac3acm_tpu.host.alloc -- itself fuzzed
bit-for-bit against liba52's a52_bit_allocate), restructured as vector ops:

  * band PSD integration: the sequential in-band log-add fold becomes a
    23-step vectorized fold over a [.., 50, 24] padded layout,
  * the leak/excitation recursion: a lax.scan over the 50 bands carrying
    (fastleak, slowleak, lowcomp, startup-state) per batch element,
  * mask -> bap: monotone-table compare-accumulates (gathers are slow).

The encoder's rate-control evaluates the *mask-independent* part once and
then maps mask -> bap -> bit cost for all 64 coarse x 16 fine SNR offsets
in parallel (replacing the reference's sequential hill climb,
ac3enc.cpp:918-975, with identical results -- the walk over precomputed
costs is replayed exactly on the host).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables as T


@lru_cache(maxsize=1)
def _band_layout():
    """Padded [50, 24] bin-index layout plus in-band position masks."""
    idx = np.zeros((50, 24), np.int32)
    valid = np.zeros((50, 24), bool)
    for b in range(50):
        sz = int(T.BNDSZ[b])
        start = int(T.BNDTAB[b])
        idx[b, :sz] = np.arange(start, start + sz)
        valid[b, :sz] = True
    return idx, valid


@lru_cache(maxsize=1)
def _size_runs():
    """Contiguous runs of equal band size: (nbands, size, first_bin) --
    the A/52 band structure is 28x1, 7x3, 6x6, 4x12, 5x24, so exact
    per-size layouts replace the padded [50, 24] one (1200 lanes, 23
    fold steps each with a 64-compare latab lookup) with 203 total
    latab lookups on narrow lanes."""
    runs = []
    b = 0
    while b < 50:
        sz = int(T.BNDSZ[b])
        lo = b
        while b < 50 and int(T.BNDSZ[b]) == sz:
            b += 1
        runs.append((b - lo, sz, int(T.BNDTAB[lo])))
    return tuple(runs)


@lru_cache(maxsize=1)
def _latab_thresholds():
    """LATAB is monotone nonincreasing, so latab[adr] = #\\{t : adr < thr_t\\}
    with thr_t = first index where latab < t.  Turns the per-element gather
    into ~64 vectorized compares."""
    lat = np.asarray(T.LATAB[:256]).astype(np.int64)
    assert (np.diff(lat) <= 0).all()
    thr = np.array([int(np.searchsorted(-lat, -t + 1))
                    for t in range(1, int(lat[0]) + 1)], np.int32)
    # sanity: reconstruct exactly
    adr = np.arange(256)
    rec = (adr[:, None] < thr[None, :]).sum(1)
    assert (rec == lat).all()
    return thr


def _latab_lookup(adr):
    thr = jnp.asarray(_latab_thresholds())
    return jnp.sum((adr[..., None] < thr).astype(jnp.int32), axis=-1)


def band_psd(psd, end):
    """psd [..., 256] int32 -> bndpsd [..., 50] int32 (log-add fold).

    `end` [...]: first excluded bin (bins >= end ignored).

    Bands are processed per size class (static contiguous slices, no
    gather): size-1 bands copy through, larger sizes fold sequentially
    in reference order, each fold running only on that class's bands.
    """
    out = []
    for nb_, sz, bin0 in _size_runs():
        p = psd[..., bin0: bin0 + nb_ * sz]
        p = p.reshape(p.shape[:-1] + (nb_, sz))          # [..., nb, sz]
        v = p[..., 0]
        if sz > 1:
            idx = (bin0 + np.arange(nb_ * sz).reshape(nb_, sz)).astype(
                np.int32)
            ok = jnp.asarray(idx) < end[..., None, None]
            for k in range(1, sz):
                nxt = p[..., k]
                c = v - nxt
                adr = jnp.minimum(jnp.abs(c) >> 1, 255)
                la = _latab_lookup(adr)
                fold = jnp.where(c >= 0, v + la, nxt + la)
                v = jnp.where(ok[..., k], fold, v)
        out.append(v)
    return jnp.concatenate(out, axis=-1)


def _calc_lowcomp(a, b0, b1, binno):
    """Vector calc_lowcomp (band index is a traced scalar)."""
    up256 = (b0 + 256) == b1
    dec = jnp.maximum(a - 64, 0)
    lt7 = jnp.where(up256, 384, jnp.where(b0 > b1, dec, a))
    lt20 = jnp.where(up256, 320, jnp.where(b0 > b1, dec, a))
    ge20 = jnp.maximum(a - 128, 0)
    return jnp.where(binno < 7, lt7, jnp.where(binno < 20, lt20, ge20))


def excitation(bndpsd, fgain, sgain, fdecay, sdecay, is_lfe,
               bndstrt=None, cplfleak=None, cplsleak=None):
    """bndpsd [..., 50] -> excite [..., 50].

    fgain may be [...] (per batch element); sgain/fdecay/sdecay are scalars
    or [...].  When bndstrt is given (coupling channel), the startup region
    is skipped and leaks start from the cpl leak-init codes.
    """
    shp = bndpsd.shape[:-1]
    nxt = jnp.concatenate([bndpsd[..., 1:], bndpsd[..., -1:]], axis=-1)
    coupled = bndstrt is not None
    if coupled:
        fl0 = (cplfleak << 8) + 768
        sl0 = (cplsleak << 8) + 768
    else:
        fl0 = jnp.zeros(shp, jnp.int32)
        sl0 = jnp.zeros(shp, jnp.int32)

    def step(carry, b):
        # b is a static Python int: the 50-band recurrence is UNROLLED so
        # XLA fuses the whole chain into one kernel (a lax.scan re-enters
        # its tiny body 50 times with carry round-trips -- measured ~25 ms
        # of the round-2 encoder's device time); branch conditions on b
        # resolve at trace time.
        fast, slow, lowcomp, startup = carry
        bp = bndpsd[..., b]
        bn = nxt[..., b]

        if coupled:
            in_region = b >= bndstrt
            fast = jnp.where(in_region,
                             jnp.maximum(fast - fdecay, bp - fgain), fast)
            slow = jnp.where(in_region,
                             jnp.maximum(slow - sdecay, bp - sgain), slow)
            exc = jnp.where(in_region, jnp.maximum(fast, slow), 0)
            return (fast, slow, lowcomp, startup), exc

        # full-bandwidth channel: startup bins 0..6 then leak region
        if b == 6:
            lc_new = jnp.where(is_lfe, lowcomp,
                               _calc_lowcomp(lowcomp, bp, bn, b))
        elif b < 22:
            lc_new = _calc_lowcomp(lowcomp, bp, bn, b)
        else:
            lc_new = lowcomp                 # unused past band 21
        skip_lc = is_lfe & (b == 6)

        if b < 2:
            exc = bp - fgain - lc_new
            return (fast, slow, lc_new, startup), exc

        # startup bins 2..6: fresh leaks, excite = fast - lowcomp
        fresh_fast = bp - fgain
        fresh_slow = bp - sgain
        # leak region (b >= begin): decay
        dec_fast = jnp.maximum(fast - fdecay, bp - fgain)
        dec_slow = jnp.maximum(slow - sdecay, bp - sgain)
        if b < 22:
            exc_leak = jnp.maximum(dec_fast - lc_new, dec_slow)
        else:
            exc_leak = jnp.maximum(dec_fast, dec_slow)

        if b < 7:
            exc_startup = fresh_fast - lc_new
            leave = (~skip_lc) & (bp <= bn)  # begin = b+1
            in_startup = startup
            exc = jnp.where(in_startup, exc_startup, exc_leak)
            fast = jnp.where(in_startup, fresh_fast, dec_fast)
            slow = jnp.where(in_startup, fresh_slow, dec_slow)
            startup = startup & ~(in_startup & leave) & (b < 6)
        else:
            exc, fast, slow = exc_leak, dec_fast, dec_slow
        return (fast, slow, lc_new, startup), exc

    carry = (fl0, sl0, jnp.zeros(shp, jnp.int32), jnp.ones(shp, bool))
    excs = []
    for b in range(50):
        carry, e = step(carry, b)
        excs.append(e)
    return jnp.stack(excs, axis=-1)


def masking_curve(bndpsd, excite, dbknee, hth_row, deltba=None):
    """excite -> mask [..., 50].  hth_row: [..., 50] already fscod/halfrate
    resolved.  deltba: [..., 50] values in {-4..4} (0 = none)."""
    tmp = dbknee - bndpsd
    v1 = excite + jnp.where(tmp > 0, tmp >> 2, 0)
    mask = jnp.maximum(v1, hth_row)
    if deltba is not None:
        mask = mask + (deltba.astype(jnp.int32) << 7)
    return mask


def bap_from_mask(psd, mask, snroffset, floor, start, end):
    """mask [..., 50] + psd [..., 256] -> bap [..., 256] (spec classes).

    snroffset may broadcast with extra leading axes (the parallel SNR
    search); start/end are [...] bin bounds.
    """
    v = mask - snroffset - floor
    v = jnp.where(v < 0, 0, v)
    v = (v & 0x1FE0) + floor
    vbin = v[..., jnp.asarray(T.MASKTAB)]                 # [..., 253]
    pad = jnp.zeros(vbin.shape[:-1] + (3,), vbin.dtype)
    vbin = jnp.concatenate([vbin, pad], axis=-1)
    address = jnp.clip((psd - vbin) >> 5, 0, 63)
    # BAPTAB is monotone nondecreasing: class = #{k : address >= lo_k}
    # (compare-accumulate instead of a per-element gather)
    lo = jnp.asarray(_class_bounds()[1:].astype(np.int32))
    bap = jnp.sum((address[..., None] >= lo).astype(jnp.int8), axis=-1)
    bins = jax.lax.broadcasted_iota(jnp.int32, (256,), 0)
    live = (bins >= start[..., None]) & (bins < end[..., None])
    return jnp.where(live, bap, 0).astype(jnp.int8)


def mantissa_bits(bap, end):
    """Per-(batch)-block mantissa bit cost with grouped-class sharing.

    bap [..., C, 256]: C channels whose group counters share one block
    (ac3enc.cpp:764-810 semantics -- counters carry across channels within
    a block and reset per block).  end [..., C].  Returns bits [...].
    """
    bins = jax.lax.broadcasted_iota(jnp.int32, (256,), 0)
    live = bins < end[..., None]
    def count(cls):
        return jnp.sum(jnp.where(live & (bap == cls), 1, 0), axis=(-1, -2))
    n1, n2, n3, n4 = count(1), count(2), count(3), count(4)
    bits = 5 * ((n1 + 2) // 3) + 7 * ((n2 + 2) // 3) + 3 * n3 \
        + 7 * ((n4 + 1) // 2)
    for cls in range(5, 16):
        w = int(T.BAP_BITS[cls])
        bits = bits + w * count(cls)
    return bits


# ---------------------------------------------------------------------------
# Histogram-based rate estimation for the encoder's SNR-offset search.
#
# psd = 3072 - 128*exp takes only 25 distinct values, and within a band all
# coefficients share the candidate threshold v_b(c) + 32*t, so the bit cost
# of *all 64* coarse offsets reduces to per-band exponent histograms
# (computed once) plus tiny prefix-sum gathers per candidate -- ~1000x less
# work than materializing bap per candidate.  Exactly equal to
# mantissa_bits(bap_from_mask(...)) by construction (tested).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _class_bounds():
    """First address of each bap class k (BAPTAB is monotone)."""
    lo = np.zeros(16, np.int32)
    for k in range(1, 16):
        lo[k] = int(np.argmax(T.BAPTAB >= k))
    return lo

def exp_histogram(exp, ends):
    """exp [..., C, 256] int32 -> per-band exponent histogram
    H [..., C, 50, 25] where H[..., b, e] = #coeffs in band b (< end)
    with exponent == e."""
    idx, valid = _band_layout()
    e = exp[..., idx]                                   # [..., C, 50, 24]
    live = valid & (idx < ends[..., None, None])
    onehot = (e[..., None] == jnp.arange(25)) & live[..., None]
    return jnp.sum(onehot, axis=-2).astype(jnp.float32)  # [..., C, 50, 25]


def bits_for_snro(psd, live, mask, snro, floor):
    """Grouped-mantissa bit cost for one (broadcastable) SNR offset,
    counted directly per bin -- no exponent histogram.

    psd  [..., C, 256] int32 (3072 - 128*exp, zero past end)
    live [..., C, 256] bool
    mask [..., C, 50]
    snro broadcastable against mask's leading axes (e.g. [B, 1, 1, 1])
    -> bits [..., ] per block (summed over channels and bins; grouped-class
    ceils applied after the channel sum -- compute_mantissa_size
    semantics, ac3enc.cpp:764-810).

    Exactly mantissa_bits(bap_from_mask(...)): a coeff's address is
    clip((psd - vbin) >> 5, 0, 63) and its class is #{k : address >= lo_k},
    so the per-class counts are 15 compare-accumulates per bin.  Versus
    the round-2 histogram route (exp_histogram + bits_for_offsets) this
    is ~5x less work per search step at the encoder's shapes: 224 live
    bins/channel instead of a 50x25 (band, exponent) lattice, and no
    histogram build at all.
    """
    lo = _class_bounds()
    v = mask - snro - floor
    v = jnp.where(v < 0, 0, v)
    v = (v & 0x1FE0) + floor                            # [..., C, 50]
    vbin = v[..., jnp.asarray(T.MASKTAB)]               # [..., C, 253]
    pad = jnp.zeros(vbin.shape[:-1] + (3,), vbin.dtype)
    vbin = jnp.concatenate([vbin, pad], axis=-1)
    base = psd - vbin                                   # [..., C, 256]
    t32 = jnp.asarray(32 * lo[1:].astype(np.int32))     # [15]
    cmp = (base[..., None] >= t32) & live[..., None]
    ge = jnp.sum(cmp.astype(jnp.int32), axis=(-3, -2))  # [..., 15]
    nk = jnp.concatenate([ge[..., :-1] - ge[..., 1:], ge[..., -1:]], -1)
    n1, n2, n3, n4 = nk[..., 0], nk[..., 1], nk[..., 2], nk[..., 3]
    bits = (5 * ((n1 + 2) // 3) + 7 * ((n2 + 2) // 3) + 3 * n3
            + 7 * ((n4 + 1) // 2))
    widths = T.BAP_BITS[5:16]                           # classes 5..15
    for j, w in enumerate(widths):
        bits = bits + int(w) * nk[..., 4 + j]
    return bits


def bits_for_offsets(hist, mask, snro, floor):
    """Grouped-mantissa bit cost for many SNR offsets at once.

    hist: exp_histogram output [..., C, 50, 25] (float32)
    mask: [..., C, 50] (snroffset-independent masking curve)
    snro: broadcastable against mask (same convention as bap_from_mask --
          e.g. candidates[:, None, None, None, None] for a leading axis)
    -> bits [S, ..., blocks...]: per-block cost summed over channels and
    coefficients, grouped-class ceils applied after the channel sum
    (compute_mantissa_size semantics, ac3enc.cpp:764-810).

    Gather-free: a coeff with exponent e has address >= t iff
    psd - v >= 32t with psd = 3072 - 128e, so each boundary count is a
    compare-and-accumulate over the 25 exponent bins -- one fused
    elementwise kernel, no bap tensor, no HBM-resident per-candidate
    per-coefficient state.
    """
    lo = _class_bounds()
    v = mask - snro - floor
    v = jnp.where(v < 0, 0, v)
    v = (v & 0x1FE0) + floor                            # [S, ..., C, 50]
    t32 = jnp.asarray(32 * lo[1:].astype(np.int32))     # boundaries t_1..t_15
    base = (3072 - v)[..., None] - t32                  # [S, ..., C, 50, 15]
    ge = jnp.zeros(v.shape[:-2] + (len(lo) - 1,), jnp.float32)
    for e in range(25):
        cmp = (base >= 128 * e).astype(jnp.float32)
        ge = ge + jnp.sum(hist[..., e, None] * cmp, axis=(-3, -2))
    ge = ge.astype(jnp.int32)                           # [S, ..., 15]
    nk = jnp.concatenate([ge[..., :-1] - ge[..., 1:], ge[..., -1:]], -1)
    n1, n2, n3, n4 = nk[..., 0], nk[..., 1], nk[..., 2], nk[..., 3]
    bits = (5 * ((n1 + 2) // 3) + 7 * ((n2 + 2) // 3) + 3 * n3
            + 7 * ((n4 + 1) // 2))
    widths = T.BAP_BITS[5:16]                           # classes 5..15
    for j, w in enumerate(widths):
        bits = bits + int(w) * nk[..., 4 + j]
    return bits
