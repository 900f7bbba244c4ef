"""Device-side AC-3 frame assembly: the bit-packer as a device program.

The reference's serial put_bits loop (ac3enc.cpp:1194-1638) reborn as data
parallelism: every frame is a *static schedule* of bit tokens (the token
COUNT and emission order are fixed by the encoder config; only lengths and
values are data), so the whole frame assembles as

    token lengths -> exclusive prefix sum  = absolute bit offsets
    token values  -> two-word shifted deposit (disjoint bits: add == or)
    CRC1/CRC2     -> GF(2)-linear maps of the payload bits: a STATIC 0/1
                     parity matrix contracted with the payload-bit vector
                     in one matmul, parity taken mod 2 (the pow_poly crc1
                     back-patch of ac3enc.cpp:1599-1638 folds into the
                     matrix at trace time)

The output is the final serial frame as uint8 [frame_size*2] on device --
byte-identical to host/pack.py:pack_frame (cross-checked in
tests/test_encoder.py).  This removes both the host bit-packing cost and
the dense-field device->host transfer (qmant/exp/bap ~55 KB/frame vs
2*frame_size bytes of finished frame).

Shape notes: the program avoids lax.cumsum and dynamic gathers -- prefix
sums run as log-shift adds, the grouped-mantissa combine uses a pointer-
doubling "first two class members after me" scan (selects only, no
gather), exponent-delta chains use static strided slices per strategy and
a select, and the token stream is assembled by concatenation in schedule
order rather than index-map gathers.  These choices were made for another
compiler; their cost on the GPU against plain cumsum/gather forms has not
been measured.

Grouped mantissas (3-in-5-bits, 3-in-7, 2-in-7 with cross-channel carry,
ac3enc.cpp:1347-1501): a head at class-ordinal k (ordinal % gsize == 0)
absorbs members k+1 (and k+2), which the doubling scan delivers.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from ..host.pack import CRC16_POLY, mul_poly, pow_poly


def _ngroups(nbc: int, gsize: int) -> int:
    return (nbc + gsize * 3 - 4) // (3 * gsize)


# ---------------------------------------------------------------------------
# trace-time constants
# ---------------------------------------------------------------------------

def _crc_tables(frame_size: int):
    """Per-byte-position GF(2) contribution tables for the two CRCs.

    crc = M(x) * x^16 mod P with the first byte highest-degree; byte i's
    bit j (LSB j=0) contributes x^(8*(n-1-i)+j+16) mod P.  crc1 is then
    multiplied by crc_inv = (P>>1)^(16*fs58-16) (the reference back-patch
    trick, ac3enc.cpp:1624-1631), which being linear folds into the table.
    """
    total = frame_size * 2
    fs58 = (frame_size >> 1) + (frame_size >> 3)
    crc_inv = pow_poly(CRC16_POLY >> 1, 16 * fs58 - 16, CRC16_POLY)

    def table(nbytes, mult):
        h = np.zeros((nbytes, 8), np.uint16)
        maxk = 8 * nbytes + 24
        xk = np.zeros(maxk, np.uint32)
        cur = 1
        for k in range(maxk):
            xk[k] = cur
            cur <<= 1
            if cur & (1 << 16):
                cur ^= CRC16_POLY
        for i in range(nbytes):
            base = 8 * (nbytes - 1 - i) + 16
            for j in range(8):
                h[i, j] = mul_poly(mult, int(xk[base + j]), CRC16_POLY)
        return h

    n1 = 2 * fs58 - 4
    n2 = total - 2 - 2 * fs58
    return (table(n1, crc_inv), table(n2, 1), fs58)


def _header_bits(cfg):
    """(lens, vals) numpy arrays for the static frame header
    (output_frame_header parity; host/pack.py:100-122).  crc1 is a 16-bit
    zero placeholder, patched after the CRC pass."""
    toks = [(16, 0x0B77), (16, 0), (2, cfg.fscod), (6, cfg.frmsizecod),
            (5, 8 + cfg.halfratecod), (3, 0), (3, cfg.acmod)]
    if (cfg.acmod & 1) and cfg.acmod != 1:
        toks.append((2, 1))
    if cfg.acmod & 4:
        toks.append((2, 1))
    if cfg.acmod == 2:
        toks.append((2, 0))
    toks.append((1, 1 if cfg.lfe else 0))
    toks.append((5, 31))
    toks += [(1, v) for v in (0, 0, 0, 0, 1, 0, 0, 0)]
    return (np.array([t[0] for t in toks], np.int32),
            np.array([t[1] for t in toks], np.uint32))


# ---------------------------------------------------------------------------
# device building blocks (all select/shift/slice; no dynamic gather)
# ---------------------------------------------------------------------------

def _psum_incl(x, chunk=32):
    """Inclusive prefix sum along the last axis as log-shift adds.
    Keeps the input dtype -- callers pick the narrowest width that can
    hold the final sum (HBM traffic, not FLOPs, bounds these scans).

    Work-efficient two-level form: log2(chunk) full-lane steps within
    chunks + a chunk-totals scan on 1/chunk of the lanes + one add,
    instead of log2(n) full-lane steps (5+1 vs 11 at n=1536)."""
    n = x.shape[-1]
    if n <= 2 * chunk:
        d = 1
        while d < n:
            pad = jnp.zeros(x.shape[:-1] + (d,), x.dtype)
            x = x + jnp.concatenate([pad, x[..., :-d]], axis=-1)
            d <<= 1
        return x
    nc = (n + chunk - 1) // chunk
    if nc * chunk != n:
        x = jnp.concatenate(
            [x, jnp.zeros(x.shape[:-1] + (nc * chunk - n,), x.dtype)],
            axis=-1)
    xr = x.reshape(x.shape[:-1] + (nc, chunk))
    d = 1
    while d < chunk:
        pad = jnp.zeros(xr.shape[:-1] + (d,), x.dtype)
        xr = xr + jnp.concatenate([pad, xr[..., :-d]], axis=-1)
        d <<= 1
    tot = xr[..., -1]                       # [..., nc] chunk totals
    d = 1
    while d < nc:
        pad = jnp.zeros(tot.shape[:-1] + (d,), x.dtype)
        tot = tot + jnp.concatenate([pad, tot[..., :-d]], axis=-1)
        d <<= 1
    excl = jnp.concatenate(
        [jnp.zeros(tot.shape[:-1] + (1,), x.dtype), tot[..., :-1]], axis=-1)
    out = (xr + excl[..., None]).reshape(x.shape[:-1] + (nc * chunk,))
    return out[..., :n]


def _first_two_after(q, m):
    """Per position i (along the last axis) and per grouped class c: the
    values of the first and second class-c members at position >= i,
    plus how many exist (0/1/2).

    q [..., n] int32 (grouped quantizer indices, <= 10); m [..., 3, n]
    bool class masks -> (v1, v2, cnt) each [..., 3, n] int32.

    Pointer-doubling with the "keep first two" monoid, with the ENTIRE
    state packed into one int32 lane: per class an MSB-aligned nibble
    stream s8 = v1<<4 | v2 plus a 2-bit count -- 30 bits for all three
    classes.  The nibble-stream encoding makes the monoid combine pure
    arithmetic ("append b's stream after a's first ac nibbles"):

        out8 = a8 | (b8 >> 4*ac),  outc = min(ac + bc, 2)

    -- no per-field selects, ~16 ops/class/step vs ~25 for the naive
    (v1, v2, cnt) select form, and one int32 array per doubling step.

    Work-efficient two-level suffix scan: log2(16) full-lane doubling
    steps within 16-wide chunks, a chunk-summary suffix scan on 1/16 of
    the lanes, then ONE full-lane combine -- 5 full-lane monoid steps
    instead of log2(n)=11."""
    OFF = (0, 10, 20)

    def fld(x, o, w):
        return (x >> o) & ((1 << w) - 1)

    def combine(x, y):
        """Monoid: x = state of nearer positions, y = farther."""
        nx = jnp.zeros_like(x)
        for o in OFF:
            a8, ac = fld(x, o, 8), fld(x, o + 8, 2)
            b8, bc = fld(y, o, 8), fld(y, o + 8, 2)
            out8 = a8 | (b8 >> (ac << 2))
            outc = jnp.minimum(ac + bc, 2)
            nx = nx | (out8 | (outc << 8)) << o
        return nx

    def suf(x, d):
        """x shifted d toward lower indices (suffix neighbor), zero pad
        (zero state = empty sequence = monoid identity)."""
        pad = jnp.zeros(x.shape[:-1] + (d,), x.dtype)
        return jnp.concatenate([x[..., d:], pad], axis=-1)

    x = jnp.zeros(q.shape, jnp.int32)
    for c, o in enumerate(OFF):
        mc = m[..., c, :]
        x = x | jnp.where(mc, (q << (o + 4)) | (1 << (o + 8)), 0)
    n = q.shape[-1]
    C = 16
    if n <= 2 * C or n % C:
        d = 1
        while d < n:
            x = combine(x, suf(x, d))
            d <<= 1
    else:
        nc = n // C
        xr = x.reshape(x.shape[:-1] + (nc, C))
        d = 1
        while d < C:                      # intra-chunk suffix states
            xr = combine(xr, suf(xr, d))
            d <<= 1
        s = xr[..., 0]                    # [..., nc] whole-chunk states
        d = 1
        while d < nc:                     # inclusive suffix over chunks
            s = combine(s, suf(s, d))
            d <<= 1
        t = suf(s, 1)                     # state of everything AFTER chunk
        x = combine(xr, t[..., None]).reshape(x.shape)
    v1 = jnp.stack([fld(x, o + 4, 4) for o in OFF], axis=-2)
    v2 = jnp.stack([fld(x, o, 4) for o in OFF], axis=-2)
    cnt = jnp.stack([fld(x, o + 8, 2) for o in OFF], axis=-2)
    return v1, v2, cnt


_GROUP_CLASSES = ((1, 3, 5, (9, 3, 1)), (2, 3, 7, (25, 5, 1)),
                  (4, 2, 7, (11, 1)))


def _mant_tokens(cls, q):
    """cls int8, q int32 [..., L]: live coefficients only, channel-major
    compacted (dead bins past each channel's nb_coefs dropped by static
    slicing; L = sum(nb_coefs) padded to the scan chunk).  Returns
    (lens int8, vals uint32) per compacted coefficient, with grouped
    classes combined onto their heads.  Compaction keeps relative order,
    so cross-channel group carries are untouched while the scans run on
    ~73% of the padded [nch*256] lanes.

    The doubling scan's whole per-position state (first/second member
    value + count, for all three classes) packs into one int32 lane --
    see _first_two_after.
    """
    cls = cls.astype(jnp.int8)
    # ungrouped lengths, arithmetically (no table gather):
    # 0 -> 0; 3 -> 3; 5..13 -> cls-1; 14 -> 14; 15 -> 16
    lens = jnp.where(cls >= 5, cls - 1,
                     jnp.where(cls == 3, jnp.int8(3), jnp.int8(0)))
    lens = jnp.where(cls == 14, jnp.int8(14), lens)
    lens = jnp.where(cls == 15, jnp.int8(16), lens).astype(jnp.int8)
    vals = q.astype(jnp.uint32)

    # grouped classes: one packed doubling scan over all three classes
    m = jnp.stack([cls == c for c, _, _, _ in _GROUP_CLASSES], axis=-2)
    qg = q & 15                           # grouped q <= 10; masked elsewhere
    # all three class ordinals in ONE prefix sum: 11-bit fields (class
    # counts <= L <= 1536 < 2048, disjoint classes never carry across)
    packed = jnp.zeros(q.shape, jnp.int32)
    for idx, (c, _, _, _) in enumerate(_GROUP_CLASSES):
        packed = packed + jnp.where(cls == c, 1 << (11 * idx), 0)
    ps = _psum_incl(packed)
    ordn = jnp.stack([((ps >> (11 * i)) & 0x7FF) - 1 for i in range(3)],
                     axis=-2)
    # strictly-after view: first/second member after position i
    a1, a2, acnt = _first_two_after(qg, m)

    def sh1(x):
        pad = jnp.zeros(x.shape[:-1] + (1,), x.dtype)
        return jnp.concatenate([x[..., 1:], pad], axis=-1)

    n1, n2, ncnt = sh1(a1), sh1(a2), sh1(acnt)
    for idx, (c, gsize, bits, mults) in enumerate(_GROUP_CLASSES):
        mi = m[..., idx, :]
        head = mi & (ordn[..., idx, :] % gsize == 0)
        hv = (mults[0] * qg
              + mults[1] * jnp.where(
                  ncnt[..., idx, :] >= 1, n1[..., idx, :], 0))
        if len(mults) == 3:
            hv = hv + mults[2] * jnp.where(
                ncnt[..., idx, :] >= 2, n2[..., idx, :], 0)
        lens = jnp.where(mi, jnp.where(head, jnp.int8(bits), jnp.int8(0)),
                         lens)
        vals = jnp.where(head, hv.astype(jnp.uint32), vals)
    return lens, vals


def _exp_group_tokens(enc_exp, strat, nb):
    """Per (block, channel): the 7-bit grouped exponent-delta tokens for
    the channel's actual strategy, padded to the D15 worst-case count.

    enc_exp [6, nch, 256] int32, strat [6, nch] -> [6, nch, gmax] uint32.
    Delta chains for each gsize come from static strided slices (no
    dynamic gather); the channel's strategy selects among them.
    """
    nch = enc_exp.shape[-2]
    gmax = _ngroups(int(nb[0]), 1)
    outs = []
    for gsize in (1, 2, 4):
        # cur_t = e[1 + t*gsize], t = 0..3*gmax-1: a strided slice, padded
        # with don't-cares past the strategy's real group count
        tmax = 3 * gmax
        sl = enc_exp[..., 1::gsize]
        if sl.shape[-1] < tmax:
            sl = jnp.concatenate(
                [sl, jnp.zeros(sl.shape[:-1] + (tmax - sl.shape[-1],),
                               sl.dtype)], axis=-1)
        cur = sl[..., :tmax]
        prev = jnp.concatenate(
            [enc_exp[..., 0:1], cur[..., :-1]], axis=-1)
        d = cur - prev + 2
        d3 = d.reshape(d.shape[:-1] + (gmax, 3))
        outs.append((d3[..., 0] * 5 + d3[..., 1]) * 5 + d3[..., 2])
    g1, g2, g4 = outs
    s = strat[..., None]
    return jnp.where(s == 1, g1, jnp.where(s == 2, g2, g4)).astype(jnp.uint32)


# ---------------------------------------------------------------------------
# the packer
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def pack_frames_device(cfg):
    """Build the jitted device packer for `cfg`.

    Returns fn(bap, qmant, enc_exp, strat, csnr, fsnr) -> uint8 frames:
      bap     [..., 6, nch, 256] int8
      qmant   [..., 6, nch, 256] int32
      enc_exp [..., 6, nch, 256] uint8
      strat   [..., 6, nch]      int32
      csnr    [...]              int32
      fsnr    [...]              int32
      ->      [..., frame_size*2] uint8
    """
    nch, nf = cfg.channels, cfg.nfchans
    lfe_ch = nf if cfg.lfe else -1
    nb = np.array(cfg.nb_coefs, np.int32)
    total = cfg.frame_size * 2
    h1_np, h2_np, fs58 = _crc_tables(cfg.frame_size)
    nwords = total // 4 + 2
    hdr_lens, hdr_vals = _header_bits(cfg)
    gmax = _ngroups(int(nb[0]), 1)
    ng_by_strat = np.zeros((nch, 4), np.int32)
    for c in range(nch):
        for s, gs in ((1, 1), (2, 2), (3, 4)):
            ng_by_strat[c, s] = _ngroups(int(nb[c]), gs)

    # compacted live-coefficient layout: channel ch occupies
    # [coff[ch], coff[ch+1]) of L16 (= sum(nb) padded to the scan chunk)
    coff = np.concatenate([[0], np.cumsum(nb)]).astype(np.int64)
    L = int(coff[-1])
    L16 = (L + 15) & ~15

    # CRC parity matrices: bit k of the CRC is the GF(2) sum (= parity)
    # of h[i,j] bit k over the set payload bits (i,j) -- an integer
    # matmul mod 2, so the XOR fold becomes one [T,16] contraction
    # of the payload-bit vector with a STATIC 0/1 matrix (exact in bf16,
    # sums <= T < 2^24 exact in f32)
    def parity_matrix(h):
        return jnp.asarray(
            ((h[:, :, None].astype(np.uint32) >> np.arange(16)) & 1)
            .reshape(-1, 16).astype(np.float32)).astype(jnp.bfloat16)

    hk1 = parity_matrix(h1_np)
    hk2 = parity_matrix(h2_np)
    garange = np.arange(gmax)

    def tokens(bap, qmant, enc_exp, strat, csnr, fsnr):
        """One frame's combined token stream: (w, p0, p1) per token."""
        strat_e = strat.astype(jnp.int32)                    # [6, nch]
        reuse = strat_e == 0

        def compact(x):
            parts = [x[:, c, : int(nb[c])] for c in range(nch)]
            if L16 > L:
                parts.append(jnp.zeros((6, L16 - L), x.dtype))
            return jnp.concatenate(parts, axis=-1)

        mant_lens, mant_vals = _mant_tokens(
            compact(bap.astype(jnp.int8)), compact(qmant))   # [6, L16]
        grp7 = _exp_group_tokens(enc_exp.astype(jnp.int16), strat_e, nb)
        # actual group count per (blk, ch) selected from the static table
        ngt = jnp.asarray(ng_by_strat)                       # [nch, 4]
        ngrp = jnp.where(
            strat_e[..., None] == jnp.asarray([1, 2, 3])[None, None, :],
            ngt[None, :, (1, 2, 3)], 0).sum(-1)              # [6, nch]

        # ---- token stream by concatenation in schedule order -------------
        lens_parts, vals_parts = [], []
        pend_l, pend_v = [], []

        def const(length, value):
            pend_l.append(length)
            pend_v.append(value)

        def flush():
            if pend_l:
                lens_parts.append(jnp.asarray(np.array(pend_l, np.int16)))
                vals_parts.append(jnp.asarray(np.array(pend_v, np.uint32)))
                pend_l.clear()
                pend_v.clear()

        def dyn(lens, vals):
            flush()
            # int16 lens: bit offsets max out at 30720 (3840-byte frames),
            # so the whole offset prefix-sum fits 16-bit lanes
            lens_parts.append(lens.astype(jnp.int16).reshape(-1))
            vals_parts.append(vals.astype(jnp.uint32).reshape(-1))

        pend_l += list(hdr_lens)
        pend_v += list(hdr_vals)

        for blk in range(6):
            for _ in range(nf):
                const(1, 0)                   # blksw: always 512-pt
            for _ in range(nf):
                const(1, 1)                   # dithflag
            const(1, 0)                       # dynrnge
            if blk == 0:
                const(1, 1)                   # cplstre
                const(1, 0)                   # cplinu
            else:
                const(1, 0)
            if cfg.acmod == 2:
                if blk == 0:
                    const(1, 1)               # rematstr
                    for _ in range(4):
                        const(1, 0)
                else:
                    const(1, 0)
            dyn(jnp.full((nf,), 2, jnp.int32), strat_e[blk, :nf])
            if cfg.lfe:
                dyn(jnp.ones((1,), jnp.int32), strat_e[blk, lfe_ch:])
            dyn(jnp.where(reuse[blk, :nf], 0, 6),
                jnp.full((nf,), 50, jnp.uint32))              # chbwcod
            for ch in range(nch):
                r = reuse[blk, ch]
                dyn(jnp.where(r, 0, 4)[None],
                    enc_exp[blk, ch, 0][None])                # first exp
                glen = jnp.where(
                    r, 0, jnp.where(jnp.asarray(garange) < ngrp[blk, ch],
                                    7, 0))
                dyn(glen, grp7[blk, ch])
                if ch != lfe_ch:
                    dyn(jnp.where(r, 0, 2)[None],
                        jnp.zeros((1,), jnp.uint32))          # gainrng
            baie = 1 if blk == 0 else 0
            const(1, baie)
            if baie:
                for ln, v in ((2, 2), (2, 1), (2, 1), (2, 2), (3, 4)):
                    const(ln, v)
            const(1, baie)                    # snroffste
            if baie:
                dyn(jnp.full((1,), 6, jnp.int32), csnr[None])
                for _ in range(nch):
                    dyn(jnp.full((1,), 4, jnp.int32), fsnr[None])
                    const(3, 4)               # fgaincod
            const(1, 0)                       # deltbaie
            const(1, 0)                       # skiple
            # static slice into the compacted layout (dead bins never
            # entered the scan)
            for ch in range(nch):
                dyn(mant_lens[blk, int(coff[ch]): int(coff[ch + 1])],
                    mant_vals[blk, int(coff[ch]): int(coff[ch + 1])])
        flush()
        lens = jnp.concatenate(lens_parts)
        vals = jnp.concatenate(vals_parts)

        # token lengths are at most 16, so the mask shift is in range
        vals = vals & ((jnp.uint32(1) << lens.astype(jnp.uint32)) - 1)

        # pair-combine adjacent tokens (l0+l1 <= 32 always): halves the
        # stream the deposit has to reduce
        if lens.shape[0] % 2:
            lens = jnp.concatenate([lens, jnp.zeros((1,), lens.dtype)])
            vals = jnp.concatenate([vals, jnp.zeros((1,), vals.dtype)])
        l0, l1 = lens[0::2], lens[1::2]
        v0, v1 = vals[0::2], vals[1::2]
        lens = (l0 + l1).astype(jnp.int16)
        vals = (v0 << l1.astype(jnp.uint32)) | v1

        # ---- deposit: prefix-sum offsets -> (word, p0, p1) per token -------
        # combined token lengths reach 32 bits: still a two-word deposit
        # (sh + len <= 31 + 32 < 64)
        off = _psum_incl(lens) - lens          # int16: max 30720 bits
        w = (off >> 5).astype(jnp.int32)
        sh = (off & 31).astype(jnp.uint32)
        lu = lens.astype(jnp.uint32)
        fits = (sh + lu) <= 32
        p0 = jnp.where(
            fits,
            vals << jnp.where(fits, (jnp.uint32(32) - sh - lu) & 31, 0),
            vals >> jnp.where(fits, 0, sh + lu - 32))
        p0 = jnp.where(lens > 0, p0, 0)
        p1 = jnp.where(
            fits, jnp.uint32(0),
            vals << jnp.where(fits, 0, (jnp.uint32(64) - sh - lu) & 31))
        return w, p0, p1

    def finish(words):
        """words [NW] uint32 -> the serial frame [total] uint8."""
        shifts = jnp.asarray(np.array([24, 16, 8, 0], np.uint32))
        all_bytes = ((words[:, None] >> shifts[None, :])
                     & 0xFF).reshape(-1)[:total]
        # reference overshoot semantics: payload truncates at total-2 and
        # crc2 overwrites the last two bytes (host/pack.py:236-243)
        byte_idx = jnp.arange(total)
        all_bytes = jnp.where(byte_idx >= total - 2, 0, all_bytes)

        # ---- CRCs as a parity matmul (GF(2)-linear; see parity_matrix) ----
        def crc_of(region, hk):
            bits = ((region[:, None] >> jnp.asarray(
                np.arange(8, dtype=np.uint32))[None, :]) & 1)
            b = bits.reshape(-1).astype(jnp.bfloat16)
            s = jnp.einsum("t,tk->k", b, hk,
                           preferred_element_type=jnp.float32)
            par = s.astype(jnp.int32) & 1
            return jnp.sum(
                par << jnp.arange(16), dtype=jnp.int32).astype(jnp.uint32)

        crc1 = crc_of(all_bytes[4: 2 * fs58], hk1)
        crc2 = crc_of(all_bytes[2 * fs58: total - 2], hk2)
        all_bytes = all_bytes.at[2].set(crc1 >> 8)
        all_bytes = all_bytes.at[3].set(crc1 & 0xFF)
        all_bytes = all_bytes.at[total - 2].set(crc2 >> 8)
        all_bytes = all_bytes.at[total - 1].set(crc2 & 0xFF)
        return all_bytes.astype(jnp.uint8)

    def one_frame(bap, qmant, enc_exp, strat, csnr, fsnr):
        """One frame, deposited by scatter-add: contributions are
        disjoint bits, so add == or.  Token offsets are a prefix sum of
        non-negative lengths, so the word indices are sorted."""
        w, p0, p1 = tokens(bap, qmant, enc_exp, strat, csnr, fsnr)
        words = jnp.zeros((nwords,), jnp.uint32)
        words = words.at[w].add(p0, mode="promise_in_bounds",
                                indices_are_sorted=True)
        words = words.at[w + 1].add(p1, mode="promise_in_bounds",
                                    indices_are_sorted=True)
        return finish(words)

    def fn(bap, qmant, enc_exp, strat, csnr, fsnr):
        f = one_frame
        for _ in bap.shape[:-3]:                  # any leading batch axes
            f = jax.vmap(f)
        return f(bap, qmant, enc_exp.astype(jnp.uint8), strat, csnr, fsnr)

    return jax.jit(fn)
