"""AC-3 encoder on the device.

Capability parity with the reference encoder (fccHandler/Bellard ac3enc,
/root/reference/src/ac3enc/ac3enc.cpp), bit-exact output frames, but
restructured for a batched accelerator:

  * the six blocks x channels x streams all window/normalize/MDCT in one
    vectorized pass (the reference loops scalar C per block),
  * exponent strategy, reuse folding, and the delta-constraint encoding run
    as static-shape vector ops (the reference's "lazy" constraint loop,
    ac3enc.cpp:730-747, is replaced by its closed-form fixpoint: the
    maximal 2-Lipschitz array below the group minima, two scan passes),
  * the SNR-offset rate-control hill climb (ac3enc.cpp:918-975) is
    flattened: the masking curve is snroffset-independent, so bap and the
    grouped-mantissa bit cost are evaluated for all 64 coarse offsets in
    parallel and the reference's exact down/up-4/up-1 walk is replayed on
    the precomputed table (same result, one device pass instead of ~15),
  * quantization (sym/asym, ac3enc.cpp:1149-1190) is elementwise int32.

Host side keeps only bit packing + CRC (ac3acm_tpu.host.pack).  Encoder
state per stream is explicit and functional: (last_samples, csnroffst) --
unlike the reference's static globals (ac3enc.cpp:78-87), this encoder is
reentrant and batchable.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables as T
from ..host import pack as PK
from ..ops import alloc as AL
from ..ops.mdct import (extract_exponents, mdct512,
                        window_norm_block)

EXP_NEW = 1
FRAME_BITS_INC = (0, 0, 2, 2, 2, 4, 2, 4)
ACMOD_BY_NCH = (1, 2, 3, 6, 7, 7)      # ac3enc.cpp:1029-1036


@dataclass(frozen=True)
class EncoderConfig:
    channels: int                      # 1..6 (6 => 5.1)
    fscod: int
    halfratecod: int
    frmsizecod: int
    frame_size: int                    # in 16-bit words
    bit_rate: int                      # kbit/s (full-rate table value)

    @property
    def acmod(self) -> int:
        return ACMOD_BY_NCH[self.channels - 1]

    @property
    def lfe(self) -> bool:
        return self.channels == 6

    @property
    def nfchans(self) -> int:
        return min(self.channels, 5)

    @property
    def nb_coefs(self):
        n = [223] * self.nfchans
        if self.lfe:
            n.append(7)
        return tuple(n)

    @property
    def sample_rate(self) -> int:
        return int(T.SAMPLE_RATES[self.fscod]) >> self.halfratecod


def make_config(freq: int, bitrate: int, channels: int) -> EncoderConfig:
    """AC3_encode_init parameter selection (ac3enc.cpp:1019-1110)."""
    if not 1 <= channels <= 6:
        raise ValueError("channels must be 1..6")
    fscod = halfratecod = None
    for hr in range(3):
        for j in range(3):
            if (int(T.SAMPLE_RATES[j]) >> hr) == freq:
                fscod, halfratecod = j, hr
                break
        if fscod is not None:
            break
    if fscod is None:
        raise ValueError(f"unsupported sample rate {freq}")
    kbps = bitrate // 1000
    idx = None
    for i in range(19):
        if (int(T.BIT_RATES[i]) >> halfratecod) == kbps:
            idx = i
            break
    if idx is None:
        raise ValueError(f"unsupported bitrate {bitrate}")
    frame_size = kbps * 1000 * T.FRAME_SAMPLES // (freq * 16)
    return EncoderConfig(channels=channels, fscod=fscod,
                         halfratecod=halfratecod, frmsizecod=idx << 1,
                         frame_size=frame_size, bit_rate=int(T.BIT_RATES[idx]))


# ---------------------------------------------------------------------------
# exponent encoding (static shapes per strategy)
# ---------------------------------------------------------------------------

def _encode_exp_static(exp, nb_coefs: int, gsize: int):
    """encode_exp for one static (nb_coefs, group size).

    exp [..., 256] int32 -> (encoded [..., 256], nbits int).  Works over
    any leading batch axes (the encoder stacks all fbw channels into one
    call per group size).

    The reference's iterative +-2 delta-constraint relaxation
    (ac3enc.cpp:730-747) converges to the maximal 2-Lipschitz array below
    the group minima.  That fixpoint is a min-plus recurrence
    c_i = min(v_i, c_{i-1} + 2), whose closed form
    f_i = 2i + cummin_j<=i(v_j - 2j) runs as a log-depth associative scan
    (and symmetrically backward) -- ~7 vector steps instead of ~75
    sequential scan iterations.
    """
    ngroups = ((nb_coefs + gsize * 3 - 4) // (3 * gsize)) * 3
    k = 1 + np.arange(ngroups)[:, None] * gsize + np.arange(gsize)[None, :]
    gmin = jnp.min(exp[..., k], axis=-1)                  # [..., ngroups]
    dc = jnp.minimum(exp[..., 0:1], 15)
    v = jnp.concatenate([dc, gmin], axis=-1)              # [..., ngroups+1]
    j2 = jnp.asarray(2 * np.arange(ngroups + 1, dtype=np.int32))
    f = jax.lax.associative_scan(jnp.minimum, v - j2, axis=-1) + j2
    g = jax.lax.associative_scan(
        jnp.minimum, (f + j2)[..., ::-1], axis=-1)[..., ::-1] - j2
    e = g                                                 # constrained exps
    out = jnp.zeros_like(exp)
    out = out.at[..., 0].set(e[..., 0])
    fan = 1 + np.arange(ngroups)[:, None] * gsize + np.arange(gsize)[None, :]
    out = out.at[..., fan.ravel()].set(
        jnp.repeat(e[..., 1:], gsize, axis=-1))
    nbits = 4 + (ngroups // 3) * 7
    return out, nbits


# ---------------------------------------------------------------------------
# quantization (ac3enc.cpp:1149-1190 exact int semantics)
# ---------------------------------------------------------------------------

def _sym_quant(c, e, levels: int):
    x = jnp.where(c >= 0, c, -c) << e
    v = (levels * x) >> 24
    v = (v + 1) >> 1
    return jnp.where(c >= 0, levels // 2 + v, levels // 2 - v)


def _asym_quant(c, e, qbits):
    lshift = e + qbits - 24
    v = jnp.where(lshift >= 0, c << jnp.maximum(lshift, 0),
                  c >> jnp.maximum(-lshift, 0))
    v = (v + 1) >> 1
    m = 1 << (qbits - 1)
    v = jnp.where(v >= m, m - 1, v)
    return v & ((1 << qbits) - 1)


def quantize(coef, enc_exp, global_exp, bap):
    """Raw per-coefficient quantized codes (before group combining)."""
    e = enc_exp - global_exp[..., None]
    out = jnp.zeros_like(coef)
    for cls, levels in ((1, 3), (2, 5), (3, 7), (4, 11), (5, 15)):
        out = jnp.where(bap == cls, _sym_quant(coef, e, levels), out)
    for cls in range(6, 16):
        qbits = cls - 1 if cls < 14 else (14 if cls == 14 else 16)
        out = jnp.where(bap == cls, _asym_quant(coef, e, qbits), out)
    return out


# ---------------------------------------------------------------------------
# device encode step
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def encode_pipeline(cfg: EncoderConfig):
    """jitted: (samples [B,1536,nch] int (any width), last [B,nch,256] i32,
    csnroffst [B] i32) -> dict of frame fields + new carry.

    Samples may arrive as int16 -- they are widened on device, so the
    host->device transfer ships 2 bytes/sample instead of 4."""
    run = _frame_body(cfg)
    return jax.jit(lambda s, last, csnr: run(s.astype(jnp.int32),
                                             last, csnr))


def _multi_body(cfg: EncoderConfig):
    """(samples [F,B,1536,nch] i32, last [B,ch,256], csnr [B]) ->
    ((last', csnr'), outs with leading [F] axis).

    A lax.scan over frames carrying (last_samples, csnroffst).  A
    scan-free variant (all F frames flattened into one [F*B] batch, with
    the csnroffst carry reduced to an F-step [B]-scalar recurrence) is
    possible because _frame_core's M is carry-independent; it has not
    been measured on the GPU."""
    run = _frame_body(cfg)

    def multi(samples, last, csnr):
        def step(carry, pcm):
            res = run(pcm, *carry)
            return (res["new_last"], res["new_csnr"]), res
        return jax.lax.scan(step, (last, csnr), samples)

    return multi


@lru_cache(maxsize=16)
def encode_pipeline_multi(cfg: EncoderConfig):
    """jitted multi-frame step: (samples [F,B,1536,nch], last, csnr) ->
    ((last', csnr'), outs with leading [F] axis)."""
    run = _multi_body(cfg)
    return jax.jit(lambda s, last, csnr: run(s.astype(jnp.int32),
                                             last, csnr))


@lru_cache(maxsize=16)
def encode_pipeline_packed(cfg: EncoderConfig):
    """Multi-frame encode + on-device bit pack:
    (samples [F,B,1536,nch] int, last, csnr) ->
    ((last', csnr'), ok [F,B] bool, frames [F,B,frame_size*2] uint8).

    The dense frame fields (qmant/exp/bap) never leave the device and the
    host never syncs between the encode and pack stages -- only the ok
    mask and the finished serial frames come back.  Encode and pack are
    two programs: one fused program measured the same on the H100 (see
    PERF.md), and on XLA:CPU it would duplicate fusions the two programs
    already have compiled (XLA:CPU keeps ~3 memory mappings live per
    fusion; long test sessions would exhaust vm.max_map_count)."""
    from ..ops.pack_device import pack_frames_device
    pack = pack_frames_device(cfg)
    multi = encode_pipeline_multi(cfg)

    def run(samples, last, csnr):
        carry, enc = multi(samples, last, csnr)
        frames = pack(enc["bap"], enc["qmant"], enc["enc_exp"],
                      enc["strat"], enc["csnroffst"], enc["fsnroffst"])
        return carry, enc["ok"], frames

    return run


def _frame_core(cfg: EncoderConfig):
    """(cur, prev) -> frame-fields dict over ANY flat leading batch.

    cur/prev [N, 6, ch, 256] int32: this frame's blocks and the
    overlapped previous blocks (prev[:, 0] is the previous frame's last
    block -- available statically from the input stream, so multi-frame
    encodes need NO sequential scan; see encode_pipeline_multi).

    Returns everything except the csnroffst bookkeeping: "M" is the
    binary-search maximum feasible coarse offset, which is independent of
    the carried csnroffst -- the reference's hill climb lands on it
    whenever rate control succeeds (ok <=> M >= csnr & 3), and on
    failure the reference errors out (ac3enc.cpp:930-933) exactly as our
    callers raise, so the carried value only matters for the ok test."""
    nch = cfg.channels
    nf = cfg.nfchans
    nb = cfg.nb_coefs
    hr = cfg.halfratecod
    sdecay = int(T.SDECAYTAB[2]) >> hr
    fdecay = int(T.FDECAYTAB[1]) >> hr
    sgain = int(T.SGAINTAB[1])
    dbknee = int(T.DBKNEETAB[2])
    floor = int(T.FLOORTAB[4])
    fgain = int(T.FGAINTAB[4])
    hth_row = T.HTH[:, cfg.fscod].astype(np.int32)

    # fixed side-info bit accounting (ac3enc.cpp:881-916); the only dynamic
    # term is 8 bits per non-REUSE fbw (block, channel) for chbwcod+gainrng
    fixed = 65 + FRAME_BITS_INC[cfg.acmod]
    for _ in range(6):
        fixed += nf * 2 + 2
        if cfg.acmod == 2:
            fixed += 1
        fixed += 2 * nf
        if cfg.lfe:
            fixed += 1
        fixed += 1 + 1 + 2
    fixed += 1
    fixed += 2 * 4 + 3 + 6 + nch * (4 + 3)
    fixed += 2 + 16
    avail_total = 16 * cfg.frame_size

    nbv = jnp.asarray(np.array(nb, np.int32))
    bins = np.arange(256)

    def core(cur, prev):
        B = cur.shape[0]
        windowed, _, exp_samples = window_norm_block(prev, cur)
        coef = mdct512(windowed)                          # [B,6,ch,256] i32
        exp, coef = extract_exponents(coef, exp_samples)

        # --- strategy (ac3enc.cpp:617-668) -------------------------------
        diff = jnp.sum(jnp.abs(exp[:, 1:] - exp[:, :-1]), axis=-1)  # [B,5,ch]
        new = jnp.concatenate(
            [jnp.ones((B, 1, nch), bool), diff > 1000], axis=1)     # [B,6,ch]
        # next_new[i] = min{j > i : new[j]} (6 if none)
        nxt_arr = []
        running = jnp.full((B, nch), 6)
        for i in range(5, -1, -1):
            nxt_arr.append(running)
            running = jnp.where(new[:, i], i, running)
        nxt_arr = nxt_arr[::-1]                           # next_new per block
        strat = []
        for i in range(6):
            runlen = nxt_arr[i] - i
            code = jnp.where(runlen == 1, T.EXP_D45,
                             jnp.where(runlen <= 3, T.EXP_D25, T.EXP_D15))
            s_i = jnp.where(new[:, i], code, T.EXP_REUSE)
            if cfg.lfe:
                s_i = s_i.at[:, nf].set(
                    jnp.where(new[:, i, nf], EXP_NEW, T.EXP_REUSE))
            strat.append(s_i)
        strat = jnp.stack(strat, axis=1)                  # [B,6,ch]

        # --- run id + exponent_min fold (ac3enc.cpp:1730-1749) ------------
        run_id = []
        rid = jnp.zeros((B, nch), jnp.int32)
        for i in range(6):
            rid = jnp.where(new[:, i], i, rid)
            run_id.append(rid)
        run_id = jnp.stack(run_id, axis=1)
        folded = exp
        for i in range(6):
            same = (run_id == run_id[:, i:i + 1])         # [B,6,ch]
            m = jnp.where(same[..., None], exp, 25)
            fmin = jnp.min(m, axis=1)                     # [B,ch,256]
            live = jnp.asarray(bins)[None, None, :] < nbv[None, :, None]
            folded = folded.at[:, i].set(
                jnp.where(live, fmin, exp[:, i]))

        # --- encode_exp per strategy (static shapes) -----------------------
        # all fbw channels share nb_coefs=223, so each group size runs ONCE
        # over a stacked [B,6,nf] leading shape (15 sequential per-channel
        # scans in round 2; now 3 log-depth calls + LFE)
        enc_exp = jnp.zeros_like(exp)
        exp_bits = jnp.zeros((B,), jnp.int32)
        fbw_exp = folded[:, :, :nf]
        for g, scode in ((1, T.EXP_D15), (2, T.EXP_D25), (4, T.EXP_D45)):
            e_s, bits_s = _encode_exp_static(fbw_exp, nb[0], g)
            sel = strat[:, :, :nf] == scode               # [B,6,nf]
            enc_exp = enc_exp.at[:, :, :nf].set(
                jnp.where(sel[..., None], e_s, enc_exp[:, :, :nf]))
            exp_bits = exp_bits + jnp.sum(sel, axis=(1, 2)) * bits_s
        if cfg.lfe:                                       # D15-only, nbc=7
            e_s, bits_s = _encode_exp_static(folded[:, :, nf], 7, 1)
            sel = strat[:, :, nf] == EXP_NEW
            enc_exp = enc_exp.at[:, :, nf].set(
                jnp.where(sel[..., None], e_s, enc_exp[:, :, nf]))
            exp_bits = exp_bits + jnp.sum(sel, axis=1) * bits_s
        # propagate encoded exponents through reuse blocks
        for i in range(1, 6):
            reuse = strat[:, i] == T.EXP_REUSE            # [B,ch]
            enc_exp = enc_exp.at[:, i].set(
                jnp.where(reuse[..., None], enc_exp[:, i - 1], enc_exp[:, i]))

        # --- masking curve (snroffset-independent) -------------------------
        live = jnp.asarray(bins)[None, None, None, :] < nbv[None, None, :, None]
        psd = jnp.where(live, 3072 - (enc_exp << 7), 0)
        ends = jnp.broadcast_to(nbv, (B, 6, nch))
        bnd = AL.band_psd(psd, ends)
        is_lfe = jnp.zeros((B, 6, nch), bool)
        if cfg.lfe:
            is_lfe = is_lfe.at[:, :, nf].set(True)
        exc = AL.excitation(bnd, fgain, sgain, fdecay, sdecay, is_lfe)
        mask = AL.masking_curve(bnd, exc, dbknee,
                                jnp.asarray(hth_row)[None, None, None, :])

        # --- frame bit budget ----------------------------------------------
        fbw_new = strat[:, :, :nf] != T.EXP_REUSE
        frame_bits = fixed + exp_bits + 8 * jnp.sum(fbw_new, axis=(1, 2))
        starts = jnp.zeros_like(ends)

        # rate model: each candidate's bit cost is 15 compare-accumulates
        # per live bin -- no bap tensor, no exponent histogram (exactly
        # equal to mantissa_bits(bap_from_mask(...)); see
        # ops.alloc.bits_for_snro)
        def bits_used(snro):
            # snro [B] broadcastable against [B,6,ch,50]
            mant = AL.bits_for_snro(psd, live, mask,
                                    snro[..., None, None, None], floor)
            return jnp.sum(mant, axis=-1)

        def fits(c, f):
            snro = (((c - 15) << 4) + f) << 2
            return (avail_total - frame_bits - bits_used(snro)) >= 0

        # --- exact replay of the reference SNR walk via monotonicity -------
        # bits_used is monotone nondecreasing in snroffset (clip & mask-low-
        # bits preserve order), so the reference's down/up-4/up-1 hill climb
        # (ac3enc.cpp:918-975) lands exactly at M = max{c : fits(c, 0)} when
        # the down pass found a fit (ok <=> the lowest reachable lattice
        # point csnr mod 4 fits <=> M >= csnr & 3), and the fine pass lands
        # at max{f : fits(M, f)}.  Binary search finds both with 12
        # single-candidate bit-cost evaluations instead of costing the full
        # 64 x 16 lattice -- byte-identity with the reference encoder is
        # held by the config-matrix / 19-bitrate tests in test_encoder.py.
        zero = jnp.zeros((B,), jnp.int32)
        lo = jnp.full((B,), -1, jnp.int32)
        hi = jnp.full((B,), 63, jnp.int32)
        for _ in range(7):                    # ceil(log2(65))
            mid = (lo + hi + 1) >> 1
            okm = fits(mid, zero)
            lo = jnp.where(okm, mid, lo)
            hi = jnp.where(okm, hi, mid - 1)
        M = lo
        flo = jnp.full((B,), -1, jnp.int32)
        fhi = jnp.full((B,), 15, jnp.int32)
        for _ in range(5):                    # ceil(log2(17))
            fmid = (flo + fhi + 1) >> 1
            okf = fits(M, fmid)
            flo = jnp.where(okf, fmid, flo)
            fhi = jnp.where(okf, fhi, fmid - 1)
        fstar = jnp.maximum(flo, 0)

        snro = ((((M - 15) << 4) + fstar) << 2)
        bap = AL.bap_from_mask(psd, mask, snro[:, None, None, None],
                               floor, starts, ends)
        qmant = quantize(coef, enc_exp, exp_samples, bap)

        return dict(bap=bap.astype(jnp.int8), qmant=qmant,
                    enc_exp=enc_exp.astype(jnp.uint8), strat=strat,
                    M=M, fsnroffst=fstar, new_last=cur[:, 5])

    return core


def _csnr_fixup(res, csnroffst):
    """Apply the carried-csnroffst bookkeeping to a _frame_core result:
    ok <=> the reference's down pass finds a fit from the carried start
    (M >= csnr & 3); cstar = M then.  On !ok every caller raises (the
    reference prints its error and aborts the frame), so the fields'
    !ok-lane values are don't-cares."""
    M = res.pop("M")
    ok = M >= (csnroffst & 3)
    cstar = jnp.where(ok, M, csnroffst)
    res = dict(res, csnroffst=cstar, ok=ok, new_csnr=cstar)
    return res


def _frame_body(cfg: EncoderConfig):
    """(samples [B,1536*nch layout], last [B,ch,256], csnr [B]) ->
    frame-fields dict; single-frame compatibility wrapper over
    _frame_core."""
    nch = cfg.channels
    core = _frame_core(cfg)

    def run(samples, last, csnroffst):
        B = samples.shape[0]
        cur = samples.reshape(B, 6, 256, nch).transpose(0, 1, 3, 2)
        prev = jnp.concatenate([last[:, None], cur[:, :5]], axis=1)
        return _csnr_fixup(core(cur, prev), csnroffst)

    return run


# ---------------------------------------------------------------------------
# public encoder
# ---------------------------------------------------------------------------

class Encoder:
    """AC3_encode_init / AC3_encode_frame parity, reentrant & batchable.

    >>> enc = Encoder(48000, 192000, 2)
    >>> frames = enc.encode(pcm_int16)     # pcm [n*1536, nch] interleaved
    """

    def __init__(self, freq: int, bitrate: int, channels: int,
                 chmap=None):
        self.cfg = make_config(freq, bitrate, channels)
        self.chmap = np.arange(channels) if chmap is None else np.asarray(chmap)
        self.last = np.zeros((1, channels, 256), np.int32)
        self.csnroffst = np.array([40], np.int32)
        self._fn = encode_pipeline(self.cfg)

    @property
    def frame_bytes(self) -> int:
        return self.cfg.frame_size * 2

    # frames per device dispatch; multi-frame inputs scan on device
    # (encode_pipeline_multi) so long encodes aren't per-frame bound
    CHUNK = 16

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm int16 [nsamples, nch] (interleaved rows); whole frames only."""
        pcm = np.asarray(pcm)
        nfr = pcm.shape[0] // T.FRAME_SAMPLES
        out = bytearray()
        i = 0
        while i < nfr:
            f = min(self.CHUNK, nfr - i)
            chunk = pcm[i * 1536:(i + f) * 1536][:, self.chmap].astype(np.int16)
            if f == 1:
                res = self._fn(chunk[None], self.last, self.csnroffst)
                res = {k: np.asarray(v)[None] for k, v in res.items()}
            else:
                frames = chunk.reshape(f, 1536, -1)[:, None]   # [F,1,1536,ch]
                fn = encode_pipeline_multi(self.cfg)
                _, res = fn(frames, self.last, self.csnroffst)
                res = {k: np.asarray(v) for k, v in res.items()}
            if not res["ok"].all():
                raise RuntimeError("rate control failed (frame too small)")
            self.last = res["new_last"][-1]
            self.csnroffst = res["new_csnr"][-1]
            out += b"".join(PK.pack_frames_native(self.cfg, res))
            i += f
        return bytes(out)
