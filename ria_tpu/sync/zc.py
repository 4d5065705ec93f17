"""Zadoff-Chu synchronization: compact preamble with frame type in the root.

Numeric contract from the reference (src/sync/zc_sync.hpp):
- ZC sequence N=127 (odd prime): zc[n] = exp(-j pi r n (n+1) / N); roots
  PING=1, PONG=3, DATA=5, CONTROL=7 (:60-107, :420-436);
- 8x linear-interpolation upsample, 2 repetitions, I/Q modulated onto a
  1500 Hz carrier with continuous phase, peak-normalized to 0.8, 10 ms gap
  (:133-190);
- detection: downconvert to baseband, normalized complex correlation against
  each enabled root template, earliest-repetition timing adjustment (40%
  rule), non-coherent repetition combining below corr 0.25 (:192-305);
- CFO from inter-repetition correlation phase: cfo = arg(c2 conj(c1)) /
  (2 pi T_rep), unambiguous +/-23.6 Hz, confidence gate 0.1 (:307-366);
- correlation -> SNR map 20 log10(c/(1-c+0.01)) clamped [-10, 30] (:628-633);
- start_sample points PAST the preamble (payload start) (:380).

Array redesign: one batched FFT correlates the window against all enabled root
templates at once; the coarse/fine stepping is replaced by evaluating every
lag exactly.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

ZC_DEFAULT_DETECT_THRESHOLD = 0.3
ZC_REP1_ADJUST_THRESHOLD = 0.4
# First-significant-tap refinement (multipath): walk back this many samples
# from the correlation peak and lock to the earliest lag >= FRACTION * peak.
ZC_FIRST_TAP_WINDOW = 120
ZC_FIRST_TAP_FRACTION = 0.45
ZC_FIRST_TAP_MIN_PEAK = 0.4
ZC_FIRST_TAP_LOBE = 16
ZC_AMPLITUDE_SCALE = 0.8
ZC_CFO_CONFIDENCE_THRESHOLD = 0.1
ZC_LOW_SNR_COHERENT_THRESHOLD = 0.25
ZC_MAX_UNAMBIGUOUS_CFO_HZ = 23.6
# CFAR secondary detector (beyond reference): the normalized correlation
# magnitude saturates at low SNR (peak ~= sqrt(S/(S+N))), but the 1016-sample
# coherent template still has ~30 dB processing gain, so the PEAK-TO-FLOOR
# ratio of the correlation stays discriminative far below the 0.3 absolute
# threshold.  Noise-only windows max out around ratio ~4.3 (Rayleigh max over
# ~46k lags x 4 roots vs Rayleigh mean); 6.0 leaves a comfortable
# false-alarm margin while extending ZC detection from ~-3 dB to ~-12 dB.
ZC_CFAR_RATIO = 6.0
ZC_CFAR_MIN_MAG = 0.04

# Frame types encoded in the ZC root
ZC_PING, ZC_PONG, ZC_DATA, ZC_CONTROL, ZC_UNKNOWN = 0, 1, 2, 3, 255

ROOT_MASK_PING = 1 << 0
ROOT_MASK_PONG = 1 << 1
ROOT_MASK_DATA = 1 << 2
ROOT_MASK_CONTROL = 1 << 3
ROOT_MASK_ALL = 0b1111


@dataclass(frozen=True)
class ZCConfig:
    sample_rate: float = 48000.0
    sequence_length: int = 127
    upsample_factor: int = 8
    num_repetitions: int = 2
    carrier_freq: float = 1500.0
    gap_ms: float = 10.0
    root_ping: int = 1
    root_pong: int = 3
    root_data: int = 5
    root_control: int = 7
    threshold: float = ZC_DEFAULT_DETECT_THRESHOLD

    @property
    def gap_samples(self) -> int:
        return int(self.sample_rate * self.gap_ms / 1000.0)

    @property
    def single_rep_samples(self) -> int:
        return self.sequence_length * self.upsample_factor

    @property
    def preamble_samples(self) -> int:
        return self.single_rep_samples * self.num_repetitions + self.gap_samples

    @property
    def roots(self) -> tuple[int, int, int, int]:
        return (self.root_ping, self.root_pong, self.root_data, self.root_control)

    def root_for_type(self, frame_type: int) -> int:
        return self.roots[frame_type] if 0 <= frame_type <= 3 else self.root_data


def zc_sequence(root: int, length: int) -> np.ndarray:
    n = np.arange(length, dtype=np.float64)
    if length % 2 == 0:
        phase = -np.pi * root * n * n / length
    else:
        phase = -np.pi * root * n * (n + 1) / length
    return np.exp(1j * phase).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _upsampled_template(cfg: ZCConfig, root: int) -> np.ndarray:
    """Linear-interpolated 8x upsampled ZC chip sequence [rep_samples] complex."""
    zc = zc_sequence(root, cfg.sequence_length)
    L, U = cfg.sequence_length, cfg.upsample_factor
    i = np.arange(L * U)
    chip_pos = i / U
    idx = chip_pos.astype(np.int64)
    frac = (chip_pos - idx).astype(np.float32)
    nxt = np.minimum(idx + 1, L - 1)
    frac = np.where(idx >= L - 1, 0.0, frac)
    return (zc[idx] * (1.0 - frac) + zc[nxt] * frac).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def generate_preamble(cfg: ZCConfig, frame_type: int) -> np.ndarray:
    """TX preamble for a frame type: repetitions + gap, peak-normalized 0.8."""
    root = cfg.root_for_type(frame_type)
    interp = _upsampled_template(cfg, root)
    rep_len = cfg.single_rep_samples
    total_sig = rep_len * cfg.num_repetitions
    t = np.arange(total_sig, dtype=np.float64) / cfg.sample_rate
    carrier = np.exp(1j * 2.0 * np.pi * cfg.carrier_freq * t)
    sig = np.real(np.tile(interp, cfg.num_repetitions) * carrier).astype(np.float32)
    peak = np.max(np.abs(sig))
    if peak > 0:
        sig *= ZC_AMPLITUDE_SCALE / peak
    return np.concatenate([sig, np.zeros(cfg.gap_samples, np.float32)])


class ZCSyncResult(NamedTuple):
    detected: jnp.ndarray     # bool
    frame_type: jnp.ndarray   # int32 (0..3, 255 unknown)
    start_sample: jnp.ndarray  # int32: PAYLOAD start (past preamble)
    correlation: jnp.ndarray  # float32
    cfo_hz: jnp.ndarray       # float32
    snr_estimate: jnp.ndarray  # float32
    root_index: jnp.ndarray   # int32 index into cfg.roots, -1 if none


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.partial(jax.jit, static_argnames=("cfg", "root_mask"))
def detect(samples: jnp.ndarray, cfg: ZCConfig, root_mask: int = ROOT_MASK_ALL,
           known_cfo_hz: float = 0.0) -> ZCSyncResult:
    """Detect a ZC preamble in a window [..., N]; batched over leading axes."""
    n = samples.shape[-1]
    rep = cfg.single_rep_samples
    if n < cfg.preamble_samples + 64:
        shape = samples.shape[:-1]
        f = jnp.zeros(shape, jnp.float32)
        return ZCSyncResult(jnp.zeros(shape, bool),
                            jnp.full(shape, ZC_UNKNOWN, jnp.int32),
                            jnp.full(shape, -1, jnp.int32), f, f, f,
                            jnp.full(shape, -1, jnp.int32))
    nfft = _next_pow2(n + rep)
    num_lags = n - rep + 1

    # Downconvert to baseband with a global-time phase ramp.
    t = jnp.arange(n, dtype=jnp.float32) / cfg.sample_rate
    dc = jnp.exp(-1j * 2.0 * jnp.pi * (cfg.carrier_freq + known_cfo_hz) * t)
    bb = samples.astype(jnp.complex64) * dc

    # Sliding rx energy (|bb| == |samples|).
    e = jnp.cumsum(jnp.square(samples.astype(jnp.float32)), axis=-1)
    zero = jnp.zeros(samples.shape[:-1] + (1,), jnp.float32)
    cs = jnp.concatenate([zero, e], axis=-1)
    rx_energy = cs[..., rep : rep + num_lags] - cs[..., :num_lags]
    ref_energy = float(rep)
    denom = jnp.sqrt(jnp.maximum(rx_energy * ref_energy, 1e-20))
    # -60 dB relative energy floor (cf. chirp _norm_correlate win_floor):
    # windows of digital silence hold only FFT leakage in corr, and the
    # ~zero denominator mints corr >> 1 false peaks (bit the round-4
    # interop harness on the reference TX's zero lead-in).  Such windows
    # cannot host a detectable preamble — mark them invalid: their mag is
    # zeroed below and the CFAR floor is averaged over VALID lags only, so
    # the detector's statistics are unchanged when no silence is present.
    lag_valid = rx_energy >= 1e-6 * jnp.max(rx_energy, axis=-1, keepdims=True)

    BB = jnp.fft.fft(bb, nfft)

    enabled = [bool(root_mask & (1 << i)) for i in range(4)]
    tmpl = np.zeros((4, rep), np.complex64)
    for i, root in enumerate(cfg.roots):
        if enabled[i]:
            tmpl[i] = _upsampled_template(cfg, root)
    T = jnp.conj(jnp.fft.fft(jnp.asarray(tmpl), nfft, axis=-1))  # [4, nfft]

    corr = jnp.fft.ifft(BB[..., None, :] * T, axis=-1)[..., :num_lags]  # [..., 4, lags]
    norm_corr = corr / denom[..., None, :]
    mag = jnp.abs(norm_corr)
    enabled_mask = jnp.asarray(enabled)[..., :, None]
    mag = jnp.where(enabled_mask & lag_valid[..., None, :], mag, 0.0)

    peak_pos = jnp.argmax(mag, axis=-1).astype(jnp.int32)        # [..., 4]
    peak_mag = jnp.take_along_axis(mag, peak_pos[..., None], -1)[..., 0]

    # Correlation floor per root (mean |corr| over VALID lags; the two
    # preamble peaks contribute negligibly to a ~46k-lag mean).  Used by
    # both the low-SNR repetition disambiguation below and the CFAR
    # detector.  Silence lags are excluded so they neither inflate (old
    # 1/denom blowup) nor deflate (zeroed mag) the noise statistic.
    n_valid = jnp.maximum(
        jnp.sum(jnp.where(enabled_mask & lag_valid[..., None, :], 1.0, 0.0),
                axis=-1), 1.0)
    floor = jnp.sum(mag, axis=-1) / n_valid                      # [..., 4]

    # Earliest-repetition timing adjustment (40% rule).  In the CFAR regime
    # (peak below the absolute threshold) argmax can land on repetition 2;
    # shift back when the lag one rep earlier also rises clearly (3x) above
    # the correlation floor, so noise alone cannot trigger the shift.
    earlier = jnp.maximum(peak_pos - rep, 0)
    earlier_mag = jnp.take_along_axis(mag, earlier[..., None], -1)[..., 0]
    confident = (peak_mag > cfg.threshold) | (earlier_mag > 3.0 * floor)
    use_earlier = confident & (peak_pos >= rep) & (
        earlier_mag > peak_mag * ZC_REP1_ADJUST_THRESHOLD)
    timing = jnp.where(use_earlier, earlier, peak_pos)

    # First-significant-tap refinement: under multipath (Watterson 2 ms
    # echo = 96 samples) the correlation peak can sit on a LATER, stronger
    # tap; locking there puts the other tap at negative delay, which no CP
    # can absorb.  Walk back up to ZC_FIRST_TAP_WINDOW samples and take the
    # EARLIEST lag whose correlation is >= ZC_FIRST_TAP_FRACTION of the
    # peak.
    offs = jnp.arange(-ZC_FIRST_TAP_WINDOW, 1, dtype=jnp.int32)
    widx = jnp.clip(timing[..., None] + offs, 0, num_lags - 1)   # [.., 4, W+1]
    wmag = jnp.take_along_axis(mag, widx, -1)
    at_peak = jnp.take_along_axis(mag, timing[..., None], -1)
    strong = wmag >= ZC_FIRST_TAP_FRACTION * at_peak
    first = jnp.argmax(strong, axis=-1)                           # leading edge
    edge = jnp.take_along_axis(widx, first[..., None], -1)[..., 0]
    # The threshold crossing sits on the tap's correlation SKIRT (the
    # band-limited main lobe is ~20 samples wide), so advance to the local
    # maximum within one main-lobe width to land on the tap itself.
    lobe = jnp.arange(ZC_FIRST_TAP_LOBE, dtype=jnp.int32)
    lidx = jnp.clip(edge[..., None] + lobe, 0, num_lags - 1)
    lmag = jnp.take_along_axis(mag, lidx, -1)
    refined = jnp.take_along_axis(
        lidx, jnp.argmax(lmag, axis=-1)[..., None], -1)[..., 0]
    # Only refine confident peaks: weak/CFO-smeared correlations have broad
    # skirts where a fraction-of-peak sidelobe is just noise.
    timing = jnp.where(at_peak[..., 0] >= ZC_FIRST_TAP_MIN_PEAK, refined, timing)

    # Low-SNR non-coherent repetition combining.
    rep2 = jnp.minimum(timing + rep, num_lags - 1)
    m1 = jnp.take_along_axis(mag, timing[..., None], -1)[..., 0]
    m2 = jnp.take_along_axis(mag, rep2[..., None], -1)[..., 0]
    combined = jnp.sqrt(m1 * m1 + m2 * m2) / jnp.sqrt(2.0)
    combined = jnp.maximum(combined, peak_mag)
    det_mag = jnp.where(peak_mag < ZC_LOW_SNR_COHERENT_THRESHOLD, combined, peak_mag)

    # CFO from inter-repetition correlation phase.
    c1 = jnp.take_along_axis(norm_corr, timing[..., None], -1)[..., 0]
    c2 = jnp.take_along_axis(norm_corr, rep2[..., None], -1)[..., 0]
    conf = (jnp.abs(c1) > ZC_CFO_CONFIDENCE_THRESHOLD) & (jnp.abs(c2) > ZC_CFO_CONFIDENCE_THRESHOLD)
    rep_duration = rep / cfg.sample_rate
    cfo = jnp.angle(c2 * jnp.conj(c1)) / (2.0 * jnp.pi * rep_duration)
    cfo = jnp.where(conf, cfo, 0.0)

    # CFAR statistic: detection peak vs the correlation floor of the same
    # root.  Disabled roots have mag == 0 everywhere (ratio 0).
    ratio = det_mag / jnp.maximum(floor, 1e-6)
    cfar_ok = (ratio > ZC_CFAR_RATIO) & (det_mag > ZC_CFAR_MIN_MAG)

    # Best root: prefer the absolute-threshold detector's winner; fall back
    # to the best CFAR ratio when no root clears the absolute threshold.
    score = jnp.where(det_mag > cfg.threshold, det_mag + 10.0,
                      jnp.where(cfar_ok, ratio / ZC_CFAR_RATIO, det_mag))
    best = jnp.argmax(score, axis=-1).astype(jnp.int32)
    best_mag = jnp.take_along_axis(det_mag, best[..., None], -1)[..., 0]
    best_ratio = jnp.take_along_axis(ratio, best[..., None], -1)[..., 0]
    best_timing = jnp.take_along_axis(timing, best[..., None], -1)[..., 0]
    best_cfo = jnp.take_along_axis(cfo, best[..., None], -1)[..., 0]

    detected = (best_mag > cfg.threshold) | (
        (best_ratio > ZC_CFAR_RATIO) & (best_mag > ZC_CFAR_MIN_MAG))
    snr = 20.0 * jnp.log10(best_mag / (1.0 - best_mag + 0.01))
    snr = jnp.clip(snr, -10.0, 30.0)

    return ZCSyncResult(
        detected=detected,
        frame_type=jnp.where(detected, best, ZC_UNKNOWN).astype(jnp.int32),
        start_sample=jnp.where(detected, best_timing + cfg.preamble_samples, -1),
        correlation=best_mag,
        cfo_hz=jnp.where(detected, best_cfo, 0.0),
        snr_estimate=snr,
        root_index=jnp.where(detected, best, -1),
    )
