"""OFDM waveform: 1024-pt FFT, CP 96, pilot-assisted MMSE equalization.

Numeric contract from the reference:
- geometry: fft=1024 @ 48 kHz (46.875 Hz bins), 59 carriers symmetric around
  DC (bins -29..-1, +1..+30), CP 96 (MEDIUM), center 1500 Hz, output scale 40
  (include/ultra/types.hpp:195-267, src/ofdm/modulator.cpp:143-181);
- constellations: Gray BPSK/QPSK/QAM16/32/64/256 exactly as
  src/ofdm/modulator.cpp:14-106; differential DBPSK/DQPSK/D8PSK across time
  per carrier from an all-ones reference, D8PSK with 22.5 deg offset
  (:406-445);
- pilots: legacy every-pilot_spacing carriers, BPSK signs from
  mt19937(0x50494C54) raw draws (:195-200); coherent modes use pilots
  (spacing 5/8 by rate), DQPSK R1/4 runs pilot-free;
- preamble: [silence fft+cp][STS x4: sync seq on even FFT bins -> two
  identical time halves][LTS x2: sync seq on all carriers + pilots]
  (:479-532); chirp-mode uses LTS training only (:534-583);
- Schmidl-Cox: M(d)=|P|/sqrt(R1 R2) on the analytic signal, CFO =
  arg(P) fs/(pi N) (src/ofdm/ofdm_sync.cpp:133-260); LTS passband
  cross-correlation fine timing, earlier-LTS preference at 92%, accept
  threshold 0.05 @ 1024 FFT (:386-480);
- equalization: MMSE conj(H) y/(|H|^2+sigma^2), soft erasure below
  0.25x average |H|^2, carrier noise var in [1e-6, 100]
  (src/ofdm/channel_equalizer.cpp:1259-1340);
- soft demap: per-modulation LLR formulas with clip +/-20 and min mag 0.01,
  CE error margins, per-carrier EMA instability inflation (K=10)
  (src/ofdm/soft_demap.hpp, src/ofdm/demodulator.cpp:234-332).

Array redesign: whole frames are demodulated as one batched program — all
symbols CP-stripped and FFT'd at once, equalized with broadcast H, demapped
vectorized; the only sequential piece (per-carrier EMA + differential chain)
is a short lax.scan over the symbol axis.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ria_tpu.utils.mt19937 import MT19937

PILOT_RNG_SEED = 0x50494C54
MAX_LLR = 20.0
MIN_LLR_MAG = 0.01
FADE_THRESHOLD_RATIO = 0.25
DEFAULT_SNR_LINEAR = 31.6
MIN_CARRIER_NOISE_VAR = 1e-6
MAX_CARRIER_NOISE_VAR = 100.0
CARRIER_ADAPTIVE_K = 10.0
MAG_EMA_ALPHA = 0.3

CE_MARGIN = {"DBPSK": 1.0, "DQPSK": 1.0, "BPSK": 1.0, "QPSK": 1.0, "D8PSK": 1.1,
             "QAM16": 1.2, "QAM32": 1.5, "QAM64": 1.8, "QAM256": 2.5}
BITS_PER_SYMBOL = {"BPSK": 1, "DBPSK": 1, "QPSK": 2, "DQPSK": 2, "D8PSK": 3,
                   "QAM16": 4, "QAM32": 5, "QAM64": 6, "QAM256": 8}
DIFFERENTIAL = ("DBPSK", "DQPSK", "D8PSK")


@dataclass(frozen=True)
class OFDMConfig:
    sample_rate: float = 48000.0
    center_freq: float = 1500.0
    fft_size: int = 1024
    num_carriers: int = 59
    # CP MEDIUM profile: base 48 x (1024/512) = 96 samples.  The modem
    # runtime's over-the-air CP: ModemEngine ctor pushes its ModemConfig
    # (cp_mode=MEDIUM, types.hpp:208) into the encoder/decoder via
    # setOFDMConfig, overriding the StreamingEncoder ctor's LONG default —
    # verified against `ria ptx` fixtures (30240-sample light frame =
    # 2x1120 LTS + 25x1120 data symbols).
    cp_len: int = 96
    symbol_guard: int = 0
    output_scale: float = 40.0
    use_pilots: bool = False
    pilot_spacing: int = 2
    modulation: str = "DQPSK"
    sync_threshold: float = 0.5
    # Optional decision-directed adaptive equalizer (LMS / RLS), coherent
    # modes only (reference channel_equalizer.cpp:1236-1369).
    adaptive_eq: bool = False
    adaptive_rls: bool = False
    lms_mu: float = 0.05
    rls_lambda: float = 0.99

    @property
    def symbol_samples(self) -> int:
        return self.fft_size + self.cp_len + self.symbol_guard

    @property
    def preamble_samples(self) -> int:
        """Schmidl-Cox preamble: guard + 4 STS + 2 LTS."""
        return self.symbol_samples + 6 * self.symbol_samples

    @property
    def num_data_carriers(self) -> int:
        return len(carrier_layout(self)[1])

    def bits_per_ofdm_symbol(self) -> int:
        return self.num_data_carriers * BITS_PER_SYMBOL[self.modulation]

    def num_symbols_for_bits(self, num_bits: int) -> int:
        return -(-num_bits // self.bits_per_ofdm_symbol())


@functools.lru_cache(maxsize=None)
def carrier_layout(cfg: OFDMConfig):
    """(all_bins, data_bins, pilot_bins) FFT bin indices (reference order)."""
    neg = cfg.num_carriers // 2
    pos = (cfg.num_carriers + 1) // 2
    all_bins, data_bins, pilot_bins = [], [], []
    count = 0
    for i in range(-neg, pos + 1):
        if i == 0:
            continue
        idx = (i + cfg.fft_size) % cfg.fft_size
        all_bins.append(idx)
        if cfg.use_pilots and count % cfg.pilot_spacing == 0:
            pilot_bins.append(idx)
        else:
            data_bins.append(idx)
        count += 1
    return (np.array(all_bins), np.array(data_bins), np.array(pilot_bins, dtype=np.int64))


@functools.lru_cache(maxsize=None)
def pilot_sequence(cfg: OFDMConfig) -> np.ndarray:
    """BPSK pilot signs from mt19937(\"PILT\") raw draws."""
    _, _, pilot_bins = carrier_layout(cfg)
    rng = MT19937(PILOT_RNG_SEED)
    return np.array([1.0 if (rng() & 1) else -1.0 for _ in range(len(pilot_bins))],
                    dtype=np.complex64)


@functools.lru_cache(maxsize=None)
def sync_sequence(cfg: OFDMConfig) -> np.ndarray:
    """Zadoff-Chu root 1, length num_carriers (modulator.cpp:183-193)."""
    N = cfg.num_carriers
    n = np.arange(N, dtype=np.float64)
    return np.exp(-1j * np.pi * 1 * n * (n + 1) / N).astype(np.complex64)


# ============================================================================
# Constellations (TX maps exactly matching modulator.cpp)
# ============================================================================

def _qam16_table():
    levels = np.array([-3, -1, 3, 1], np.float64)
    scale = 1 / np.sqrt(10)
    out = np.zeros(16, np.complex64)
    for b in range(16):
        out[b] = complex(levels[(b >> 2) & 3] * scale, levels[b & 3] * scale)
    return out


def _qam32_table():
    i_levels = [-3, -1, 1, 3]
    i_gray = [0, 1, 3, 2]
    q_levels = [-7, -5, -3, -1, 1, 3, 5, 7]
    q_gray = [0, 1, 3, 2, 6, 7, 5, 4]
    scale = 1 / np.sqrt(26)
    out = np.zeros(32, np.complex64)
    for b in range(32):
        qb, ib = (b >> 2) & 7, b & 3
        qi = q_gray.index(qb)
        ii = i_gray.index(ib)
        out[b] = complex(i_levels[ii] * scale, q_levels[qi] * scale)
    return out


def _qam64_table():
    levels = np.array([-7, -5, -1, -3, 7, 5, 1, 3], np.float64)
    scale = 1 / np.sqrt(42)
    out = np.zeros(64, np.complex64)
    for b in range(64):
        out[b] = complex(levels[(b >> 3) & 7] * scale, levels[b & 7] * scale)
    return out


def _qam256_table():
    levels = np.array([-15, -13, -9, -11, -1, -3, -7, -5, 15, 13, 9, 11, 1, 3, 7, 5], np.float64)
    scale = 1 / np.sqrt(170)
    out = np.zeros(256, np.complex64)
    for b in range(256):
        out[b] = complex(levels[(b >> 4) & 15] * scale, levels[b & 15] * scale)
    return out


@functools.lru_cache(maxsize=None)
def constellation_table(mod: str) -> np.ndarray:
    s = 1 / np.sqrt(2)
    if mod == "BPSK":
        return np.array([-1, 1], np.complex64)
    if mod == "QPSK":
        return np.array([complex(-s, -s), complex(-s, s), complex(s, -s), complex(s, s)],
                        np.complex64)
    if mod == "QAM16":
        return _qam16_table()
    if mod == "QAM32":
        return _qam32_table()
    if mod == "QAM64":
        return _qam64_table()
    if mod == "QAM256":
        return _qam256_table()
    if mod == "DBPSK":
        return np.array([1, -1], np.complex64)
    if mod == "DQPSK":
        return np.array([1, 1j, -1, -1j], np.complex64)
    if mod == "D8PSK":
        ang = np.arange(8) * (np.pi / 4) + np.pi / 8
        return np.exp(1j * ang).astype(np.complex64)
    raise ValueError(mod)


# ============================================================================
# TX (host numpy)
# ============================================================================

def _bits_to_carrier_symbols(bits: np.ndarray, cfg: OFDMConfig) -> np.ndarray:
    """bits -> per-carrier constellation/differential symbols [S, D].

    Carriers whose bit group starts past the end of the data transmit ZERO
    (the reference modulator's per-carrier loop exits when data runs out and
    pads the remaining carriers with 0 — modulator.cpp modulate(); only the
    last symbol is affected).  A carrier that straddles the end gets
    zero-padded bits and is still transmitted.
    """
    bpc = BITS_PER_SYMBOL[cfg.modulation]
    D = cfg.num_data_carriers
    per_sym = D * bpc
    S = -(-len(bits) // per_sym)
    padded = np.zeros(S * per_sym, np.int64)
    padded[: len(bits)] = bits
    grouped = padded.reshape(S, D, bpc)
    vals = np.zeros((S, D), np.int64)
    for b in range(bpc):
        vals = (vals << 1) | grouped[..., b]
    table = constellation_table(cfg.modulation)
    # Active mask: carrier (s, d) is transmitted iff its first bit index is
    # within the real data.
    start = (np.arange(S)[:, None] * D + np.arange(D)[None, :]) * bpc
    active = start < len(bits)
    if cfg.modulation in DIFFERENTIAL:
        rot = table[vals]
        sym = np.cumprod(rot, axis=0)  # differential from all-ones reference
        return np.where(active, sym, 0).astype(np.complex64)
    return np.where(active, table[vals], 0).astype(np.complex64)


def _ofdm_symbols_to_time(carrier_syms: np.ndarray, cfg: OFDMConfig,
                          include_pilots: bool = True) -> np.ndarray:
    """[S, D] -> complex time-domain CP+FFT symbols [S, sym_samples]."""
    _, data_bins, pilot_bins = carrier_layout(cfg)
    S = carrier_syms.shape[0]
    freq = np.zeros((S, cfg.fft_size), np.complex64)
    freq[:, data_bins] = carrier_syms
    if include_pilots and len(pilot_bins):
        freq[:, pilot_bins] = pilot_sequence(cfg)[None, :]
    td = np.fft.ifft(freq, axis=-1).astype(np.complex64)
    with_cp = np.concatenate([td[:, -cfg.cp_len:], td], axis=-1)
    if cfg.symbol_guard:
        with_cp = np.concatenate(
            [with_cp, np.zeros((S, cfg.symbol_guard), np.complex64)], axis=-1)
    return with_cp


def _mix_to_real(complex_stream: np.ndarray, cfg: OFDMConfig, tx_cfo_hz: float = 0.0) -> np.ndarray:
    """Continuous-phase upmix from t=0 + output scaling."""
    n = complex_stream.shape[-1]
    t = np.arange(n, dtype=np.float64)
    carrier = np.exp(2j * np.pi * (cfg.center_freq + tx_cfo_hz) * t / cfg.sample_rate)
    return (np.real(complex_stream * carrier) * cfg.output_scale).astype(np.float32)


def _sts_symbol(cfg: OFDMConfig) -> np.ndarray:
    """Schmidl-Cox STS: sync seq on even FFT bins among data carriers."""
    _, data_bins, _ = carrier_layout(cfg)
    seq = sync_sequence(cfg)
    freq = np.zeros(cfg.fft_size, np.complex64)
    for seq_idx, bin_idx in enumerate(data_bins):
        if bin_idx % 2 == 0:
            freq[bin_idx] = seq[seq_idx % len(seq)]
    td = np.fft.ifft(freq).astype(np.complex64)
    return np.concatenate([td[-cfg.cp_len:], td])


def _lts_symbol(cfg: OFDMConfig) -> np.ndarray:
    _, data_bins, _ = carrier_layout(cfg)
    seq = sync_sequence(cfg)
    lts_data = seq[np.arange(len(data_bins)) % len(seq)][None, :]
    return _ofdm_symbols_to_time(lts_data, cfg, include_pilots=True)[0]


def generate_preamble(cfg: OFDMConfig, tx_cfo_hz: float = 0.0) -> np.ndarray:
    """Full Schmidl-Cox preamble: silence + STS x4 + LTS x2 (passband)."""
    guard = np.zeros(cfg.fft_size + cfg.cp_len, np.float32)
    sts = _sts_symbol(cfg)
    lts = _lts_symbol(cfg)
    stream = np.concatenate([np.tile(sts, 4), np.tile(lts, 2)])
    return np.concatenate([guard, _mix_to_real(stream, cfg, tx_cfo_hz)])


def generate_training(cfg: OFDMConfig, count: int = 2, tx_cfo_hz: float = 0.0) -> np.ndarray:
    """LTS training symbols only (chirp-acquisition mode). NOTE: for phase
    coherence with modulate(), use tx_frame() which mixes in one stream."""
    lts = _lts_symbol(cfg)
    return _mix_to_real(np.tile(lts, count), cfg, tx_cfo_hz)


def modulate(bits: np.ndarray, cfg: OFDMConfig, tx_cfo_hz: float = 0.0,
             mixer_offset: int = 0) -> np.ndarray:
    """Data bits -> passband samples; mixer phase starts at sample mixer_offset."""
    syms = _bits_to_carrier_symbols(np.asarray(bits, np.int64), cfg)
    stream = _ofdm_symbols_to_time(syms, cfg).reshape(-1)
    n = stream.shape[0]
    t = (np.arange(n, dtype=np.float64) + mixer_offset)
    carrier = np.exp(2j * np.pi * (cfg.center_freq + tx_cfo_hz) * t / cfg.sample_rate)
    return (np.real(stream * carrier) * cfg.output_scale).astype(np.float32)


def tx_frame(bits: np.ndarray, cfg: OFDMConfig, preamble: str = "cox",
             training_count: int = 2, tx_cfo_hz: float = 0.0) -> np.ndarray:
    """Preamble + data in one phase-coherent stream.

    preamble="cox": silence + 4 STS + 2 LTS + data (OFDM-COX waveform).
    preamble="lts": training LTS only (chirp/ZC-synced waveforms prepend
    their own sync signal before this).
    """
    syms = _bits_to_carrier_symbols(np.asarray(bits, np.int64), cfg)
    data_stream = _ofdm_symbols_to_time(syms, cfg).reshape(-1)
    lts = _lts_symbol(cfg)
    if preamble == "cox":
        sts = _sts_symbol(cfg)
        stream = np.concatenate([np.tile(sts, 4), np.tile(lts, 2), data_stream])
        head = np.zeros(cfg.fft_size + cfg.cp_len, np.float32)
        return np.concatenate([head, _mix_to_real(stream, cfg, tx_cfo_hz)])
    stream = np.concatenate([np.tile(lts, training_count), data_stream])
    return _mix_to_real(stream, cfg, tx_cfo_hz)


# ============================================================================
# RX: Schmidl-Cox search (jitted)
# ============================================================================

class SCSyncResult(NamedTuple):
    detected: jnp.ndarray
    lts_start: jnp.ndarray   # sample index of the FIRST LTS symbol
    cfo_hz: jnp.ndarray
    metric: jnp.ndarray      # SC correlation at detection
    lts_corr: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("cfg",))
def schmidl_cox_search(samples: jnp.ndarray, cfg: OFDMConfig) -> SCSyncResult:
    """Find the preamble in a window: SC metric for gating/CFO + LTS fine timing."""
    from ria_tpu.dsp.hilbert import analytic_signal

    n = samples.shape[-1]
    N = cfg.fft_size
    half = N // 2
    sym = cfg.symbol_samples
    if n < cfg.preamble_samples + 64:
        shape = samples.shape[:-1]
        f = jnp.zeros(shape, jnp.float32)
        return SCSyncResult(jnp.zeros(shape, bool), jnp.full(shape, -1, jnp.int32),
                            f, f, f)

    def sliding(x, w):
        c = jnp.cumsum(x, axis=-1)
        zero = jnp.zeros(x.shape[:-1] + (1,), x.dtype)
        cs = jnp.concatenate([zero, c], axis=-1)
        return cs[..., w:] - cs[..., :-w]

    # Coarse SC metric on a MIX + BOX-SUM decimated complex baseband (the
    # chirp zoom-search trick): multiply by the center-frequency NCO and
    # sum groups of DEC samples — one fused elementwise pass instead of
    # the Hilbert transform's 2x 64k-point FFT pair (which was ~45% of
    # this search's device time).  The 2fc image the mix leaves behind is
    # noise-like to the STS autocorrelation and the box-sum's sinc already
    # attenuates it.  The metric's plateau spans ~4 STS symbols, so a
    # DEC-sample lag grid cannot miss it, and the LTS cross-correlation
    # below refines timing to the sample.  The mix contributes a constant
    # fc*half/fs turns to the lag-half conjugate product (exactly 16.0 at
    # the production fs=48k/fc=1500 geometry); the fractional part is
    # compensated below so any OFDMConfig geometry stays correct.
    DEC = 8
    frac_half = float((cfg.center_freq * half / cfg.sample_rate) % 1.0)
    nblk = n // DEC
    t_full = jnp.arange(nblk * DEC, dtype=jnp.float32)
    rot = jnp.exp(-2j * jnp.pi * (cfg.center_freq / cfg.sample_rate) * t_full)
    zb = (samples[..., : nblk * DEC] * rot).reshape(
        samples.shape[:-1] + (nblk, DEC)).sum(-1)
    half_d = half // DEC
    zc_d = jnp.conj(zb[..., :-half_d]) * zb[..., half_d:]
    absz2_d = jnp.square(jnp.abs(zb))
    w_d = half // DEC
    P = sliding(zc_d, w_d)                     # P[j] ~ sum over [j*DEC, +half)
    R1 = sliding(absz2_d, w_d)
    R2 = sliding(absz2_d[..., w_d:], w_d)
    m = min(P.shape[-1], R2.shape[-1])
    P, R1, R2 = P[..., :m], R1[..., :m], R2[..., :m]
    # -60 dB energy floor (cf. chirp _norm_correlate win_floor): windows of
    # silence/zero padding hold only numeric residue, and dividing by their
    # energy mints false metric peaks that can outscore the real preamble.
    rr = R1 * R2
    rr_floor = 1e-6 * jnp.max(rr, axis=-1, keepdims=True)
    M = jnp.abs(P) / jnp.sqrt(jnp.maximum(jnp.maximum(rr, rr_floor), 1e-20))

    # offset d has data_start = d + cp -> decimated metric index
    # j = (d + cp) / DEC
    cp_d = cfg.cp_len // DEC
    num_lags = max(m - cp_d, 1)
    Md = M[..., cp_d : cp_d + num_lags]
    peak_d = jnp.argmax(Md, axis=-1).astype(jnp.int32)
    peak_val = jnp.take_along_axis(Md, peak_d[..., None], -1)[..., 0]
    peak = peak_d * DEC                         # full-rate preamble offset

    # CFO at the peak.
    Pd = P[..., cp_d : cp_d + num_lags]
    P_peak = jnp.take_along_axis(Pd, peak_d[..., None], -1)[..., 0]
    P_peak = P_peak * np.exp(2j * np.pi * frac_half)  # undo the mix residue
    cfo = jnp.angle(P_peak) * cfg.sample_rate / (jnp.pi * N)
    max_cfo = cfg.sample_rate / N
    cfo = jnp.clip(cfo, -max_cfo, max_cfo)

    # LTS fine timing: passband cross-correlation of the known LTS symbol,
    # restricted to a dynamic slice around the expected LTS (peak + 4 sym
    # +/- the old search span) — an 8192-point FFT correlation instead of
    # the whole-window next-pow2 one.
    lts = _lts_symbol(cfg)
    # LTS template as TX'd when it follows 4 STS symbols (mixer phase offset);
    # correlation magnitude over the analytic template is phase-invariant, so
    # the offset does not matter.
    lts_analytic = np.asarray(
        np.exp(2j * np.pi * cfg.center_freq * (np.arange(len(lts)) + 4 * sym) / cfg.sample_rate)
        * lts * cfg.output_scale, np.complex64)
    ref_energy = float(np.sum(np.abs(lts_analytic) ** 2)) * 0.5

    L = len(lts)
    # The SC metric of 4 identical STS symbols (each with two identical
    # halves) is a ~4-symbol plateau, and the argmax can land anywhere on
    # it — the candidate window must span the WHOLE plateau or the true
    # LTS can fall just outside it (observed: peak at plateau end put the
    # first LTS 1 sample below the old -3*sym bound; the second repeat
    # then decoded one symbol late).
    span = 4 * sym + sym // 2                  # candidate lag span
    R = span + L + DEC                         # slice length (static)
    nfft = 1 << (R - 1).bit_length()
    expected = peak + 4 * sym
    lo = jnp.clip(expected - 4 * sym, 0, max(n - R, 0))
    sl = jax.vmap(lambda a, s: jax.lax.dynamic_slice(a, (s,), (R,)))(
        samples.reshape(-1, n), lo.reshape(-1)).reshape(samples.shape[:-1] + (R,))
    X = jnp.fft.fft(sl.astype(jnp.complex64), nfft)
    H = jnp.conj(jnp.fft.fft(jnp.asarray(lts_analytic), nfft))
    xc = jnp.fft.ifft(X * H)[..., : R - L]
    e = sliding(jnp.square(sl.astype(jnp.float32)), L)[..., : xc.shape[-1]]
    e_floor = 1e-6 * jnp.max(e, axis=-1, keepdims=True)
    lts_corr_all = jnp.abs(xc) / jnp.sqrt(
        jnp.maximum(jnp.maximum(e, e_floor) * ref_energy, 1e-12))

    # Candidate mask inside the slice: [expected-3sym, expected+sym/2]
    # relative to lo (only the front clamp can shift it).
    lags = jnp.arange(lts_corr_all.shape[-1], dtype=jnp.int32)
    lo_rel = (expected - 4 * sym - lo)[..., None]
    hi_rel = (expected + sym // 2 - lo)[..., None]
    masked = jnp.where((lags >= lo_rel) & (lags <= hi_rel), lts_corr_all, -1.0)
    pos_rel = jnp.argmax(masked, axis=-1).astype(jnp.int32)
    lts_val = jnp.take_along_axis(masked, pos_rel[..., None], -1)[..., 0]

    # Prefer the earlier of the two LTS repeats (92% rule).
    prev_rel = jnp.maximum(pos_rel - sym, 0)
    prev_val = jnp.take_along_axis(lts_corr_all, prev_rel[..., None], -1)[..., 0]
    take_prev = (pos_rel >= sym) & (prev_val >= lts_val * 0.92)
    pos_rel = jnp.where(take_prev, prev_rel, pos_rel)
    lts_val = jnp.where(take_prev, prev_val, lts_val)
    lts_pos = lo + pos_rel

    # Fine CFO from the LTS repeat pair (phase drift over one symbol),
    # wrap-resolved against the coarse SC estimate.  The decimated SC
    # P-sum alone is ~sqrt(DEC) noisier than the old full-rate sum; the
    # LTS pair at the refined timing is tighter than either.
    seg_len = sym + L
    seg = jax.vmap(lambda a, s: jax.lax.dynamic_slice(a, (s,), (seg_len,)))(
        samples.reshape(-1, n),
        jnp.clip(lts_pos, 0, max(n - seg_len, 0)).reshape(-1)
    ).reshape(samples.shape[:-1] + (seg_len,))
    # Analytic transform of just the SLICE (a 4096-pt FFT pair — the whole
    # point of dropping the full-window Hilbert) kills the 2fc image,
    # which is itself a coherent LTS repeat and would fold the pair
    # product onto the real axis (angle -> 0, erasing the CFO).
    segz = analytic_signal(seg)
    r = jnp.sum(segz[..., :L] * jnp.conj(segz[..., sym : sym + L]), axis=-1)
    # The passband carrier contributes fc*sym/fs turns to the repeat-pair
    # product (integer — 35.0 — at the production geometry); compensate
    # the fractional residue for arbitrary configs.
    frac_sym = float((cfg.center_freq * sym / cfg.sample_rate) % 1.0)
    r = r * np.exp(2j * np.pi * frac_sym)
    spacing = cfg.sample_rate / sym
    cfo_fine = -jnp.angle(r) * spacing / (2.0 * jnp.pi)
    k = jnp.round((cfo - cfo_fine) / spacing)
    cfo = jnp.where(jnp.abs(r) > 1e-12, cfo_fine + k * spacing, cfo)

    lts_threshold = 0.05 if cfg.fft_size >= 1024 else 0.35
    detected = (peak_val > cfg.sync_threshold) & (lts_val > lts_threshold)

    return SCSyncResult(
        detected=detected,
        lts_start=jnp.where(detected, lts_pos, -1),
        cfo_hz=jnp.where(detected, cfo, 0.0),
        metric=peak_val,
        lts_corr=lts_val,
    )


class LTSSyncResult(NamedTuple):
    detected: jnp.ndarray
    lts_start: jnp.ndarray
    corr: jnp.ndarray
    cfo_hz: jnp.ndarray = jnp.float32(0.0)
    # Number of LTS repeats at the sync point (2 = normal frame, 3 = burst
    # marker).  The reference marks burst-interleaved frames with a NEGATED
    # LTS (waveform_interface.hpp:164-166); magnitude correlation cannot
    # carry a sign, so this build marks bursts with a third LTS repeat —
    # equally cheap to detect (one extra correlation lookup) and robust
    # under CFO.
    repeats: jnp.ndarray = jnp.int32(2)


@functools.partial(jax.jit, static_argnames=("cfg", "threshold"))
def lts_search(samples: jnp.ndarray, cfg: OFDMConfig, threshold: float = 0.5) -> LTSSyncResult:
    """Find an LTS training symbol by passband cross-correlation (light
    preamble / chirp-acquisition frames where no STS is transmitted).

    The LTS template here is mixed from t=0 (chirp-mode TX resets the mixer at
    training start); correlation magnitude is phase-invariant anyway.
    Prefers the earlier of two adjacent LTS repeats (92% rule).

    Threshold calibration (measured): a true LTS correlates >=0.92 on AWGN
    down to 8 dB and >=0.70 under Watterson good/moderate/poor fading;
    band-limited noise peaks at ~0.14 and a co-channel chirp preamble (the
    worst structured interferer: a connecting peer's retransmits) at ~0.31.
    0.5 sits between the populations — the reference's fixed 0.35
    (ofdm_sync.cpp:386-479) admits chirp interference as false sync here.
    """
    n = samples.shape[-1]
    sym = cfg.symbol_samples
    lts = _lts_symbol(cfg)
    L = len(lts)
    if n < 2 * L + 64:
        shape = samples.shape[:-1]
        return LTSSyncResult(jnp.zeros(shape, bool), jnp.full(shape, -1, jnp.int32),
                             jnp.zeros(shape, jnp.float32))
    lts_analytic = np.asarray(
        np.exp(2j * np.pi * cfg.center_freq * np.arange(L) / cfg.sample_rate) * lts
        * cfg.output_scale, np.complex64)
    ref_energy = float(np.sum(np.abs(lts_analytic) ** 2)) * 0.5

    nfft = 1 << (n + L - 1).bit_length()
    X = jnp.fft.fft(samples.astype(jnp.complex64), nfft)
    H = jnp.conj(jnp.fft.fft(jnp.asarray(lts_analytic), nfft))
    xc = jnp.fft.ifft(X * H)[..., : max(n - L, 1)]

    c = jnp.cumsum(jnp.square(samples.astype(jnp.float32)), axis=-1)
    zero = jnp.zeros(samples.shape[:-1] + (1,), jnp.float32)
    cs = jnp.concatenate([zero, c], axis=-1)
    e = (cs[..., L:] - cs[..., :-L])[..., : xc.shape[-1]]
    # -60 dB energy floor (cf. chirp _norm_correlate win_floor): windows of
    # digital silence hold only FFT leakage residue in xc; dividing that by
    # a vanishing window energy mints corr > 1 false peaks (bit the round-4
    # interop harness on the reference TX's zero lead-in).
    e_floor = 1e-6 * jnp.max(e, axis=-1, keepdims=True)
    corr = jnp.abs(xc) / jnp.sqrt(jnp.maximum(jnp.maximum(e, e_floor) * ref_energy, 1e-12))

    # EARLIEST detection above threshold, not the global argmax: several
    # back-to-back light frames can sit in one search window (a selective-
    # repeat window of 4 queues contiguously), and taking the strongest LTS
    # would silently skip the frames before it (the reference's sequential
    # correlation scan stops at the first hit, ofdm_sync.cpp:386-479).
    # argmax of the boolean mask returns the FIRST position above threshold;
    # a local argmax over the following symbol period then centers on that
    # preamble's true peak.
    above = corr > threshold
    first = jnp.argmax(above, axis=-1).astype(jnp.int32)
    local = jnp.minimum(first[..., None] + jnp.arange(sym, dtype=jnp.int32),
                        corr.shape[-1] - 1)
    lvals = jnp.take_along_axis(corr, local, -1)
    pos = jnp.take_along_axis(
        local, jnp.argmax(lvals, axis=-1)[..., None].astype(jnp.int32), -1)[..., 0]
    has_any = jnp.any(above, axis=-1)
    pos = jnp.where(has_any, pos, jnp.argmax(corr, axis=-1).astype(jnp.int32))
    val = jnp.take_along_axis(corr, pos[..., None], -1)[..., 0]
    # Prefer the earliest repeat (92% rule), applied twice so a 3-repeat
    # burst preamble whose argmax lands on repeat 3 still walks back to
    # repeat 1.
    for _ in range(2):
        prev_pos = jnp.maximum(pos - sym, 0)
        prev_val = jnp.take_along_axis(corr, prev_pos[..., None], -1)[..., 0]
        take_prev = (pos >= sym) & (prev_val >= val * 0.92)
        pos = jnp.where(take_prev, prev_pos, pos)
        val = jnp.where(take_prev, prev_val, val)
    det = val > threshold
    # First-significant-tap refinement (cf. sync/zc.py): under multipath
    # (Watterson 0.5-2 ms echoes = 24-96 samples) the correlation peak can
    # sit on a LATER, stronger tap.  Locking there puts the FFT window 24+
    # samples late — PAST the symbol boundary, so every symbol takes ISI
    # from its successor (late lock is outside the CP's safe zone; early
    # lock within the CP is free).  Coherent QAM16 at a true 20 dB Good
    # read 27-45% BER from symbol 0 because of this; differential modes
    # masked it.  Walk back up to one echo span and take the EARLIEST lag
    # whose correlation clears 0.6x the peak, then hop to its local lobe
    # maximum (the band-limited main lobe is ~20 samples wide).
    offs_ft = jnp.arange(-48, 1, dtype=jnp.int32)
    widx = jnp.clip(pos[..., None] + offs_ft, 0, corr.shape[-1] - 1)
    wvals = jnp.take_along_axis(corr, widx, -1)
    strong = wvals >= 0.6 * val[..., None]
    first_i = jnp.argmax(strong, axis=-1)
    edge = jnp.take_along_axis(widx, first_i[..., None], -1)[..., 0]
    lobe = jnp.arange(12, dtype=jnp.int32)
    lidx = jnp.clip(edge[..., None] + lobe, 0, corr.shape[-1] - 1)
    lvals_ft = jnp.take_along_axis(corr, lidx, -1)
    refined = jnp.take_along_axis(
        lidx, jnp.argmax(lvals_ft, axis=-1)[..., None], -1)[..., 0]
    refined = jnp.minimum(refined, pos)
    pos = jnp.where(det, refined, pos)
    val = jnp.take_along_axis(corr, pos[..., None], -1)[..., 0]
    # CFO from the inter-repeat phase of the two LTS training symbols (the
    # light preamble is always LTS x2): the analytic matched-filter output
    # rotates by 2*pi*cfo*sym/fs between repeats, unambiguous to
    # +-fs/(2*sym) = +-21.4 Hz — same trick as ZC repetition CFO
    # (zc_sync.hpp:58) applied to the LTS pair.
    pos2 = jnp.minimum(pos + sym, xc.shape[-1] - 1)
    xc1 = jnp.take_along_axis(xc, pos[..., None], -1)[..., 0]
    xc2 = jnp.take_along_axis(xc, pos2[..., None], -1)[..., 0]
    val2 = jnp.take_along_axis(corr, pos2[..., None], -1)[..., 0]
    dphi = jnp.angle(xc2 * jnp.conj(xc1))
    cfo = dphi * cfg.sample_rate / (2.0 * jnp.pi * sym)
    cfo = jnp.where(val2 >= 0.5 * val, cfo, 0.0)  # weak 2nd repeat: no estimate
    # Burst marker: a third LTS repeat (see LTSSyncResult.repeats).
    pos3 = jnp.minimum(pos + 2 * sym, corr.shape[-1] - 1)
    val3 = jnp.take_along_axis(corr, pos3[..., None], -1)[..., 0]
    repeats = jnp.where(val3 >= 0.5 * val, jnp.int32(3), jnp.int32(2))
    return LTSSyncResult(det, jnp.where(det, pos, -1), val, cfo, repeats)


# ============================================================================
# RX: presynced demodulation (jitted)
# ============================================================================

class OFDMDemodResult(NamedTuple):
    soft_bits: jnp.ndarray      # [..., S*D*bps]
    snr_db: jnp.ndarray
    noise_var: jnp.ndarray
    fading_index: jnp.ndarray   # CV of |H| over data carriers
    channel_mag: jnp.ndarray    # [..., D]
    symbols: jnp.ndarray        # [..., S, D] equalized data-carrier symbols
    #                             (constellation feed, reference GUI snapshots)


def _demap(mod: str, eq: jnp.ndarray, prev: jnp.ndarray, nv: jnp.ndarray):
    """Vectorized per-carrier demap -> LLRs [..., D, bps]. `prev` only for
    differential modes. LLR > 0 => bit 0 (reference convention)."""
    def clip(l):
        c = jnp.clip(l, -MAX_LLR, MAX_LLR)
        return jnp.where(jnp.abs(c) < MIN_LLR_MAG,
                         jnp.where(c >= 0, MIN_LLR_MAG, -MIN_LLR_MAG), c)

    I, Q = jnp.real(eq), jnp.imag(eq)
    if mod == "BPSK":
        return clip(-2.0 * I / nv)[..., None]
    if mod == "QPSK":
        scale = -2.0 * (1 / np.sqrt(2)) / nv
        return clip(jnp.stack([I * scale, Q * scale], axis=-1))
    if mod == "QAM16":
        thr = 2 / np.sqrt(10)
        s = 2.0 / nv
        return clip(jnp.stack([-s * I, s * (jnp.abs(I) - thr),
                               -s * Q, s * (jnp.abs(Q) - thr)], axis=-1))
    if mod == "QAM32":
        pts = constellation_table("QAM32")
        d2 = jnp.square(jnp.abs(eq[..., None] - pts))  # [..., D, 32]
        bits = np.arange(32)
        llrs = []
        s = 2.0 / nv
        for b in range(5):
            mask1 = (bits >> (4 - b)) & 1 == 1
            d1 = jnp.min(jnp.where(mask1, d2, jnp.inf), axis=-1)
            d0 = jnp.min(jnp.where(~mask1, d2, jnp.inf), axis=-1)
            llrs.append(s * (d1 - d0))
        return clip(jnp.stack(llrs, axis=-1))
    if mod == "QAM64":
        d4, d2c = 4 / np.sqrt(42), 2 / np.sqrt(42)
        s = 2.0 / nv
        return clip(jnp.stack([
            -s * I, s * (jnp.abs(I) - d4), s * (jnp.abs(jnp.abs(I) - d4) - d2c),
            -s * Q, s * (jnp.abs(Q) - d4), s * (jnp.abs(jnp.abs(Q) - d4) - d2c)],
            axis=-1))
    if mod == "QAM256":
        d8, d4c, d2c = 8 / np.sqrt(170), 4 / np.sqrt(170), 2 / np.sqrt(170)
        s = 2.0 / nv
        return clip(jnp.stack([
            -s * I, s * (jnp.abs(I) - d8), s * (jnp.abs(jnp.abs(I) - d8) - d4c),
            s * (jnp.abs(jnp.abs(jnp.abs(I) - d8) - d4c) - d2c),
            -s * Q, s * (jnp.abs(Q) - d8), s * (jnp.abs(jnp.abs(Q) - d8) - d4c),
            s * (jnp.abs(jnp.abs(jnp.abs(Q) - d8) - d4c) - d2c)], axis=-1))

    # Differential modes
    diff = eq * jnp.conj(prev)
    dI, dQ = jnp.real(diff), jnp.imag(diff)
    signal_power = jnp.abs(eq) * jnp.abs(prev)
    weak = signal_power < 1e-6
    diff_nv = 2.0 * nv
    if mod == "DBPSK":
        phase = jnp.arctan2(dQ, dI)
        conf = 2.0 * signal_power / diff_nv
        llr = clip(conf * jnp.cos(phase))
        return jnp.where(weak[..., None], 0.0, llr[..., None])
    if mod == "DQPSK":
        mag = jnp.abs(diff)
        snr_lin = signal_power / diff_nv
        scale = 2.0 * jnp.sqrt(snr_lin)
        phase = jnp.arctan2(dQ, dI)
        l0 = clip(scale * jnp.sin(phase + jnp.pi / 4))
        l1 = clip(scale * (jnp.abs(dI) - jnp.abs(dQ)) / jnp.maximum(mag, 1e-9))
        out = jnp.stack([l0, l1], axis=-1)
        return jnp.where((mag < 1e-6)[..., None], 0.0, out)
    if mod == "D8PSK":
        phase = jnp.arctan2(dQ, dI)
        conf = signal_power / diff_nv
        out = jnp.stack([clip(conf * jnp.sin(phase)),
                         clip(conf * jnp.sin(2 * phase)),
                         clip(conf * jnp.sin(4 * phase))], axis=-1)
        return jnp.where(weak[..., None], 0.0, out)
    raise ValueError(mod)


def _affine_prefix(x: jnp.ndarray, init: jnp.ndarray, alpha: float) -> jnp.ndarray:
    """BEFORE-step states of the EMA recurrence s_n = (1-a)*s_{n-1} + a*x_n
    along axis -2: out[..., n, :] = state after consuming x[..., :n, :],
    out[..., 0, :] = init.  Log-depth parallel prefix over the affine maps
    (A, B) -> s = A*s_prev + B, composed associatively."""
    a = 1.0 - alpha
    A = jnp.full_like(x, a)
    B = alpha * x
    # Fold the init into the first element so the scan is init-free.
    B = B.at[..., 0, :].add(a * init)

    def compose(l, r):
        return (l[0] * r[0], l[1] * r[0] + r[1])

    A_acc, after = jax.lax.associative_scan(compose, (A, B), axis=-2)
    del A_acc
    return jnp.concatenate([init[..., None, :], after[..., :-1, :]], axis=-2)


@functools.partial(jax.jit, static_argnames=("cfg", "num_data_symbols", "training_symbols"))
def demodulate_presynced(samples: jnp.ndarray, cfo_hz: jnp.ndarray, cfg: OFDMConfig,
                         num_data_symbols: int, training_symbols: int = 2) -> OFDMDemodResult:
    """Demodulate [T training LTS + S data] symbols starting at the first LTS.

    samples: [..., (T+S)*symbol_samples] passband audio; batched over leading
    axes.  CFO is removed by complex downmix at center_freq + cfo.
    """
    T, S = training_symbols, num_data_symbols
    sym = cfg.symbol_samples
    need = (T + S) * sym
    x = samples[..., :need]

    _, data_bins, pilot_bins = carrier_layout(cfg)

    t = jnp.arange(need, dtype=jnp.float32) / cfg.sample_rate
    dc = jnp.exp(-1j * 2.0 * jnp.pi * (cfg.center_freq + jnp.asarray(cfo_hz)[..., None]) * t)
    bb = x.astype(jnp.complex64) * dc

    syms = bb.reshape(bb.shape[:-1] + (T + S, sym))
    core = syms[..., cfg.cp_len : cfg.cp_len + cfg.fft_size]
    freq = jnp.fft.fft(core, axis=-1)  # [..., T+S, fft]

    Y_data = freq[..., data_bins]      # [..., T+S, D]
    Y_pilot = freq[..., pilot_bins] if len(pilot_bins) else None
    return demodulate_from_bins(Y_data, Y_pilot, cfg, S, T)


def demodulate_from_bins(Y_data: jnp.ndarray, Y_pilot: jnp.ndarray | None,
                         cfg: OFDMConfig, num_data_symbols: int,
                         training_symbols: int = 2) -> OFDMDemodResult:
    """Demod back half, from the per-symbol carrier bins Y [..., T+S, D]
    (continuous-downmix convention of demodulate_presynced).  Split out so
    the sequence-parallel stream RX (parallel/stream.py) can assemble Y
    across shards with a psum and run this stage replicated."""
    T, S = training_symbols, num_data_symbols
    _, data_bins, pilot_bins = carrier_layout(cfg)
    D = len(data_bins)
    mod = cfg.modulation

    # LTS channel estimate: H = mean(Y / X_known) over training symbols.
    seq = sync_sequence(cfg)
    lts_data = seq[np.arange(D) % len(seq)]
    H_data = jnp.mean(Y_data[..., :T, :] / lts_data, axis=-2)  # [..., D]
    if Y_pilot is not None:
        H_pilot = jnp.mean(Y_pilot[..., :T, :] / pilot_sequence(cfg), axis=-2)

    # Noise variance from LTS repeat difference (per-carrier avg, /2 for the
    # difference of two noisy copies).
    if T >= 2:
        d = (Y_data[..., 1, :] - Y_data[..., 0, :])
        noise_var = jnp.mean(jnp.square(jnp.abs(d)), axis=-1) / 2.0
    else:
        noise_var = jnp.mean(jnp.square(jnp.abs(H_data)), axis=-1) / DEFAULT_SNR_LINEAR
    noise_var = jnp.maximum(noise_var, 1e-9)

    h_power = jnp.square(jnp.abs(H_data))
    avg_h_power = jnp.mean(h_power, axis=-1, keepdims=True)
    fade_thr = FADE_THRESHOLD_RATIO * avg_h_power

    Yd = Y_data[..., T:, :]  # [..., S, D]
    coherent_mod = mod in ("BPSK", "QPSK", "QAM16", "QAM32", "QAM64", "QAM256")
    nv = noise_var[..., None, None]
    if coherent_mod and Y_pilot is not None and len(pilot_bins) > 1:
        # Per-symbol pilot channel TRACKING with frequency interpolation
        # (reference channel_equalizer.cpp:645,1049 pilot tracking).  The
        # old common-phase-only correction left the LTS estimate frozen
        # for the whole frame: on a Good-class channel the two Rayleigh
        # taps rotate independently and the per-carrier interference
        # pattern drifts — coherent QAM16 decoded 1/10 single frames at a
        # true 20 dB (the reference's own proof point claims 96% there).
        # Track the RATIO H_s/H_lts at each pilot, interpolate it across
        # carriers (static linear-weight matmul), and re-scale the dense
        # LTS estimate — the accurate frame-start shape plus the pilots'
        # drift information.
        pos = np.cumsum(np.ones(cfg.num_carriers)) - 1  # 0..58 carrier order
        order_bins, order_data, order_pilot = carrier_layout(cfg)
        is_pilot = np.isin(order_bins, order_pilot)
        pos_pilot = pos[is_pilot]
        pos_data = pos[~is_pilot]
        W = np.zeros((len(pos_data), len(pos_pilot)), np.float32)
        for di, pd in enumerate(pos_data):
            j = int(np.searchsorted(pos_pilot, pd))
            if j == 0:
                W[di, 0] = 1.0
            elif j >= len(pos_pilot):
                W[di, -1] = 1.0
            else:
                t = (pd - pos_pilot[j - 1]) / (pos_pilot[j] - pos_pilot[j - 1])
                W[di, j - 1] = 1.0 - t
                W[di, j] = t
        Yp = Y_pilot[..., T:, :]
        Hp_s = Yp / pilot_sequence(cfg)                       # [..., S, P]
        base = jnp.where(jnp.abs(H_pilot) > 1e-9, H_pilot, 1.0)
        ratio = Hp_s / base[..., None, :]
        # Clamp the ratio: near a deep pilot null the quotient explodes;
        # the true drift over a frame is a modest rotation/scale.
        rmag = jnp.abs(ratio)
        ratio = ratio * (jnp.clip(rmag, 0.25, 4.0)
                         / jnp.maximum(rmag, 1e-9))
        # Time-EMA the ratio (first-order linear recurrence, associative
        # scan like the demap's EMA chain), anchored at the LTS baseline
        # (ratio 1): the per-symbol pilot estimate carries noise that cost
        # QAM64 2-4 codewords per clean 24 dB burst when applied raw; the
        # EMA keeps the tracking bandwidth (~0.1 Hz Doppler needs only a
        # few-symbol lag) while averaging the pilot noise down.
        a = 0.35
        ones_r = jnp.ones_like(ratio[..., :1, :])
        A = jnp.concatenate([ones_r * (1.0 - a)] * ratio.shape[-2], axis=-2)
        Bv = a * ratio
        # seed: r~_{-1} = 1  =>  first element B' = (1-a)*1 + a*r_0
        Bv = Bv.at[..., 0, :].add((1.0 - a))

        def comb(x, y):
            return (x[0] * y[0], y[0] * x[1] + y[1])

        _, ratio_s = jax.lax.associative_scan(comb, (A, Bv), axis=-2)
        R = ratio_s @ jnp.asarray(W.T).astype(jnp.complex64)  # [..., S, D]
        # Near-AWGN gate: on a flat channel the per-carrier interpolation
        # only injects pilot noise into an already-optimal LTS estimate
        # (QAM64 lost 2 codewords on one clean 24 dB seed with it always
        # on) — but the COMMON phase still drifts with residual CFO, and
        # dropping that correction entirely zeroed a whole clean burst.
        # So the flat-channel branch applies the pilot-weighted common
        # phase/gain only; the selective branch keeps the full per-carrier
        # ratio.  Gate at the 0.15 AWGN-class CV boundary the selection
        # tables use.
        h_mag0 = jnp.abs(H_data)
        cv0 = jnp.std(h_mag0, axis=-1) / jnp.maximum(
            jnp.mean(h_mag0, axis=-1), 1e-9)
        wgt = jnp.square(jnp.abs(base))[..., None, :]
        r_common = (jnp.sum(ratio_s * wgt, axis=-1)
                    / jnp.maximum(jnp.sum(wgt, axis=-1), 1e-12))
        R = jnp.where((cv0 > 0.15)[..., None, None], R,
                      r_common[..., None])
        H_s = H_data[..., None, :] * R
        hp_s = jnp.square(jnp.abs(H_s))
        denom = hp_s + nv
        eq = Yd * jnp.conj(H_s) / jnp.maximum(denom, 1e-10)
        carrier_nv = nv / jnp.maximum(denom, 1e-10)
        carrier_nv = jnp.where(hp_s < fade_thr[..., None, :],
                               MAX_CARRIER_NOISE_VAR, carrier_nv)
        carrier_nv = jnp.clip(carrier_nv, MIN_CARRIER_NOISE_VAR,
                              MAX_CARRIER_NOISE_VAR)
    else:
        # Pilot-based common phase correction per data symbol (differential
        # modes: the per-carrier chain handles amplitude drift itself).
        if Y_pilot is not None and len(pilot_bins) > 0:
            Yp = Y_pilot[..., T:, :]
            expect = H_pilot[..., None, :] * pilot_sequence(cfg)
            rot = jnp.sum(Yp * jnp.conj(expect), axis=-1)  # [..., S]
            phase = jnp.angle(rot)
            Yd = Yd * jnp.exp(-1j * phase)[..., None]

        # MMSE equalization (broadcast over symbols).
        denom = h_power[..., None, :] + nv
        eq = Yd * jnp.conj(H_data[..., None, :]) / jnp.maximum(denom, 1e-10)
        carrier_nv = nv / jnp.maximum(denom, 1e-10)
        carrier_nv = jnp.where(h_power[..., None, :] < fade_thr[..., None, :],
                               MAX_CARRIER_NOISE_VAR, carrier_nv)
        carrier_nv = jnp.clip(carrier_nv, MIN_CARRIER_NOISE_VAR, MAX_CARRIER_NOISE_VAR)
    carrier_nv = jnp.broadcast_to(carrier_nv, eq.shape)

    # Per-carrier EMA instability inflation + differential chain: scan over S.
    ce_margin = CE_MARGIN[mod]

    h_mag_pre = jnp.abs(H_data)
    mean_h_pre = jnp.mean(h_mag_pre, axis=-1)
    fading_pre = jnp.where(mean_h_pre > 1e-9,
                           jnp.std(h_mag_pre, axis=-1) / jnp.maximum(mean_h_pre, 1e-9), 0.0)

    def scan_fn(carry, inp):
        ema, var, prev = carry
        eq_s, nv_s = inp  # [..., D]
        mag = jnp.abs(eq_s)
        delta = mag - ema
        ema_n = ema + MAG_EMA_ALPHA * delta
        var_n = var + MAG_EMA_ALPHA * (delta * delta - var)
        norm_var = var / jnp.maximum(ema * ema, 1e-6)
        nv_eff = nv_s * ce_margin * (1.0 + CARRIER_ADAPTIVE_K * norm_var)

        if mod == "D8PSK":
            # Two-pass D8PSK on fading channels (demodulator.cpp:533-630):
            # pass 1 estimates the weighted circular-mean phase error vs the
            # embedded DQPSK grid; pass 2 applies a 50% partial correction
            # when 3 deg < |err| < 15 deg.  Gated on fading index > 0.30.
            diff = eq_s * jnp.conj(prev)
            power = jnp.abs(eq_s) * jnp.abs(prev)
            phase = jnp.angle(diff)
            quad = jnp.round((phase - jnp.pi / 4) / (jnp.pi / 2))
            expected = quad * (jnp.pi / 2) + jnp.pi / 4
            err = phase - expected
            err = jnp.where(err > jnp.pi, err - 2 * jnp.pi, err)
            err = jnp.where(err < -jnp.pi, err + 2 * jnp.pi, err)
            w = jnp.where(power > 0.1, power, 0.0)
            sin_sum = jnp.sum(w * jnp.sin(err), axis=-1)
            cos_sum = jnp.sum(w * jnp.cos(err), axis=-1)
            mean_err = jnp.where(jnp.sum(w, axis=-1) > 0.1,
                                 jnp.arctan2(sin_sum, cos_sum), 0.0)
            apply = ((jnp.abs(mean_err) > 0.05) & (jnp.abs(mean_err) < 0.26)
                     & (fading_pre > 0.30))
            corr = jnp.where(apply, -0.5 * mean_err, 0.0)
            eq_s = eq_s * jnp.exp(1j * corr)[..., None]

        llr = _demap(mod, eq_s, prev, nv_eff)
        return (ema_n, var_n, eq_s), llr

    coherent = mod in ("BPSK", "QPSK", "QAM16", "QAM32", "QAM64", "QAM256")
    if cfg.adaptive_eq and coherent:
        # Decision-directed LMS/RLS: track per-carrier weights from the LTS
        # estimate; equalize each symbol with the current weights, then
        # update toward the hard decision (channel_equalizer.cpp:1343-1369).
        table = jnp.asarray(constellation_table(mod))

        def hard_decision(v):
            d2 = jnp.square(jnp.abs(v[..., None] - table))
            return table[jnp.argmin(d2, axis=-1)]

        def adapt_fn(carry, inp):
            ema, var, prev, w, P = carry
            y_s, _ = inp
            h2 = jnp.square(jnp.abs(w))
            denom = jnp.maximum(h2 + noise_var[..., None], 1e-10)
            eq_s = y_s * jnp.conj(w) / denom
            nv_s = jnp.clip(noise_var[..., None] / denom,
                            MIN_CARRIER_NOISE_VAR, MAX_CARRIER_NOISE_VAR)
            mag = jnp.abs(eq_s)
            delta = mag - ema
            ema_n = ema + MAG_EMA_ALPHA * delta
            var_n = var + MAG_EMA_ALPHA * (delta * delta - var)
            norm_var = var / jnp.maximum(ema * ema, 1e-6)
            nv_eff = nv_s * ce_margin * (1.0 + CARRIER_ADAPTIVE_K * norm_var)
            llr = _demap(mod, eq_s, prev, nv_eff)
            dec = hard_decision(eq_s)
            errv = y_s - w * dec
            if cfg.adaptive_rls:
                ref_norm = jnp.square(jnp.abs(dec))
                k = P / (cfg.rls_lambda + P * ref_norm)
                w_n = w + k * jnp.conj(dec) * errv
                P_n = jnp.clip((P - k * ref_norm * P) / cfg.rls_lambda, 1e-3, 1e3)
            else:
                w_n = w + cfg.lms_mu * jnp.conj(dec) * errv
                P_n = P
            return (ema_n, var_n, eq_s, w_n, P_n), (llr, eq_s)

        y_t = jnp.moveaxis(Yd, -2, 0)
        w0 = jnp.broadcast_to(H_data, y_t[0].shape).astype(jnp.complex64)
        P0 = jnp.ones(y_t[0].shape, jnp.float32)
        ema0 = jnp.abs(y_t[0] * jnp.conj(w0)
                       / jnp.maximum(jnp.square(jnp.abs(w0)) + noise_var[..., None], 1e-10))
        var0 = jnp.zeros_like(ema0)
        prev0 = jnp.ones_like(y_t[0])
        (_, _, _, _, _), (llrs, eq_syms) = jax.lax.scan(
            adapt_fn, (ema0, var0, prev0, w0, P0), (y_t, jnp.moveaxis(carrier_nv, -2, 0)))
        llrs = jnp.moveaxis(llrs, 0, -3)
        eq_syms = jnp.moveaxis(eq_syms, 0, -2)
        soft = llrs.reshape(llrs.shape[:-3] + (S * D * BITS_PER_SYMBOL[mod],))
        h_mag = jnp.abs(H_data)
        mean_h = jnp.mean(h_mag, axis=-1)
        fading = jnp.where(mean_h > 1e-9,
                           jnp.std(h_mag, axis=-1) / jnp.maximum(mean_h, 1e-9), 0.0)
        snr_db = 10.0 * jnp.log10(jnp.maximum(avg_h_power[..., 0] / noise_var, 1e-6))
        return OFDMDemodResult(soft_bits=soft, snr_db=snr_db, noise_var=noise_var,
                               fading_index=fading, channel_mag=h_mag,
                               symbols=eq_syms)

    if mod == "D8PSK":
        # The two-pass phase correction rotates eq_s before it becomes the
        # next symbol's differential reference — a true sequential
        # dependency; keep the scan.
        eq_t = jnp.moveaxis(eq, -2, 0)          # [S, ..., D]
        nv_t = jnp.moveaxis(carrier_nv, -2, 0)
        ema0 = jnp.abs(eq_t[0])
        var0 = jnp.zeros_like(ema0)
        prev0 = jnp.ones_like(eq_t[0])
        (_, _, _), llrs = jax.lax.scan(scan_fn, (ema0, var0, prev0), (eq_t, nv_t))
        # llrs: [S, ..., D, bps] -> [..., S*D*bps]
        llrs = jnp.moveaxis(llrs, 0, -3)
    else:
        # Symbol-parallel path (the per-symbol lax.scan serialized ~5x of
        # this chain's single-chip throughput): the differential reference
        # is just the previous symbol's equalized value, and the
        # EMA/variance instability chain is a first-order LINEAR recurrence
        # — both computable in parallel (shifted array; log-depth
        # associative scan).  Bit-exact with scan_fn for every non-D8PSK
        # modulation.
        mags = jnp.abs(eq)                       # [..., S, D]
        ema_before = _affine_prefix(mags, mags[..., 0, :], MAG_EMA_ALPHA)
        delta = mags - ema_before
        var_before = _affine_prefix(delta * delta,
                                    jnp.zeros_like(mags[..., 0, :]),
                                    MAG_EMA_ALPHA)
        norm_var = var_before / jnp.maximum(ema_before * ema_before, 1e-6)
        nv_eff = carrier_nv * ce_margin * (1.0 + CARRIER_ADAPTIVE_K * norm_var)
        prev_all = jnp.concatenate(
            [jnp.ones_like(eq[..., :1, :]), eq[..., :-1, :]], axis=-2)
        llrs = _demap(mod, eq, prev_all, nv_eff)  # [..., S, D, bps]
    soft = llrs.reshape(llrs.shape[:-3] + (S * D * BITS_PER_SYMBOL[mod],))

    h_mag = jnp.abs(H_data)
    mean_h = jnp.mean(h_mag, axis=-1)
    fading = jnp.where(mean_h > 1e-9, jnp.std(h_mag, axis=-1) / jnp.maximum(mean_h, 1e-9), 0.0)
    snr_db = 10.0 * jnp.log10(jnp.maximum(avg_h_power[..., 0] / noise_var, 1e-6))

    return OFDMDemodResult(soft_bits=soft, snr_db=snr_db, noise_var=noise_var,
                           fading_index=fading, channel_mag=h_mag, symbols=eq)
