"""Dual linear-FM chirp synchronization (batched FFT matched filter).

Numeric contract from the reference (src/sync/chirp_sync.hpp):
- up-chirp 300->2700 Hz over 500 ms, 100 ms gap, down-chirp 2700->300 Hz,
  100 ms gap (~1.2 s total), amplitude 0.5 (generate(): :61-108);
- detection = complex (analytic) template cross-correlation, magnitude peak,
  normalized by sqrt(sliding signal energy * template energy)
  (detectChirpTemplateFFT :627-709);
- dual-chirp CFO: correlation peaks shift by -/+ CFO*fs/chirp_rate for
  up/down chirps, so CFO = gap_error / (2*fs/chirp_rate) and the true
  up-chirp start is up_pos + CFO*fs/chirp_rate (detectDualChirp :352-512);
- reject |CFO| > 100 Hz; default threshold 0.15.

Array redesign: the whole search window is one (batched) FFT correlation and an
argmax — there is no coarse/fine stepping; every lag is evaluated at once.

For large windows a zoom-FFT fast path computes the correlation on a
decimated lag grid first: the matched-filter output c(tau) = IFFT(X * conj(U))
has spectrum support limited to the chirp band, so keeping only the first
nfft/_ZOOM_DECIM bins (a 3 kHz band at D=16/fs=48k, holding the
300-2700 Hz chirp with a ~300 Hz leakage guard — floors re-measured
10/10 at -14 dB) and running an nfft/D-point IFFT yields c(D*m)
(critically-sampled band-limited signal) at 1/D of the transform cost, from a
single shared rfft of the input.  The coarse argmax is then refined to
sample resolution with one small matmul (shifted-template columns)
that also produces the exact normalized correlation value used for
thresholding — so detection semantics match the full-resolution path.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class ChirpConfig:
    sample_rate: float = 48000.0
    f_start: float = 300.0
    f_end: float = 2700.0
    duration_ms: float = 500.0
    gap_ms: float = 100.0
    amplitude: float = 0.5
    use_dual_chirp: bool = True
    threshold: float = 0.15
    # CFAR acceptance (beyond reference, mirrors the ZC detector's CFAR):
    # accept when the up-chirp peak stands cfar_ratio above the median
    # normalized correlation of the window, with absolute floors.  Measured
    # populations (120k windows, stationary noise): true chirps have
    # peak/median >= 22 down to -14 dB AWGN / -11 dB Watterson-good; pure
    # noise <= 4.0.  The old all-absolute rule (both chirps >= 0.15)
    # dropped frames whose down-chirp faded to ~0.13 at -11 dB good.
    cfar_ratio: float = 6.0
    cfar_abs_floor: float = 0.06
    cfar_down_floor: float = 0.08

    @property
    def chirp_samples(self) -> int:
        return int(self.sample_rate * self.duration_ms / 1000.0)

    @property
    def gap_samples(self) -> int:
        return int(self.sample_rate * self.gap_ms / 1000.0)

    @property
    def total_samples(self) -> int:
        if self.use_dual_chirp:
            return 2 * self.chirp_samples + 2 * self.gap_samples
        return self.chirp_samples + self.gap_samples

    @property
    def chirp_rate(self) -> float:
        return (self.f_end - self.f_start) / (self.duration_ms / 1000.0)

    @property
    def cfo_to_samples(self) -> float:
        """Correlation-peak shift per Hz of CFO (~10 samples/Hz)."""
        return self.sample_rate / self.chirp_rate


class ChirpSyncResult(NamedTuple):
    detected: jnp.ndarray   # bool
    start: jnp.ndarray      # int32, CFO-corrected up-chirp start
    cfo_hz: jnp.ndarray     # float32
    up_corr: jnp.ndarray    # float32
    down_corr: jnp.ndarray  # float32


def _chirp_phase(cfg: ChirpConfig, up: bool) -> np.ndarray:
    t = np.arange(cfg.chirp_samples, dtype=np.float64) / cfg.sample_rate
    k = cfg.chirp_rate
    if up:
        return 2.0 * np.pi * (cfg.f_start * t + 0.5 * k * t * t)
    return 2.0 * np.pi * (cfg.f_end * t - 0.5 * k * t * t)


@functools.lru_cache(maxsize=None)
def generate(cfg: ChirpConfig, tx_cfo_hz: float = 0.0) -> np.ndarray:
    """TX chirp sequence [up][gap][down][gap] as float32 samples."""
    t = np.arange(cfg.chirp_samples, dtype=np.float64) / cfg.sample_rate
    out = np.zeros(cfg.total_samples, dtype=np.float32)
    up = cfg.amplitude * np.sin(_chirp_phase(cfg, up=True) + 2 * np.pi * tx_cfo_hz * t)
    out[: cfg.chirp_samples] = up
    if cfg.use_dual_chirp:
        down_start = cfg.chirp_samples + cfg.gap_samples
        down = cfg.amplitude * np.sin(_chirp_phase(cfg, up=False) + 2 * np.pi * tx_cfo_hz * t)
        out[down_start : down_start + cfg.chirp_samples] = down
    return out


@functools.lru_cache(maxsize=None)
def _templates(cfg: ChirpConfig):
    """Unit-amplitude analytic templates (cos + j sin) and their energies."""
    up = np.exp(1j * _chirp_phase(cfg, up=True)).astype(np.complex64)
    down = np.exp(1j * _chirp_phase(cfg, up=False)).astype(np.complex64)
    # Template energy of the real (sin) template, as the reference normalizes
    # against its stored sin template: sum sin^2 ~= N/2.
    energy = float(np.sum(np.sin(_chirp_phase(cfg, up=True)) ** 2))
    return up, down, energy


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


# Zoom fast path: decimate the correlation lag grid by this factor.  The
# kept band nfft/_ZOOM_DECIM bins = fs/_ZOOM_DECIM Hz must contain the
# chirp band: at D=16 that is 3 kHz (+/-1500 Hz around the 1500 Hz band
# center) against the chirp's +/-1200 Hz — a ~300 Hz leakage guard, which
# measured 10/10 detections at -14 dB with CFO and exact timing
# (2026-08-21 sweep).  D=32 would alias (band 1500 Hz < chirp width).
_ZOOM_DECIM = 16
# Refinement half-width in samples around the coarse peak (>= _ZOOM_DECIM so
# the true peak is always inside the refined search).
_ZOOM_REFINE = 24
_ZOOM_MIN_NFFT = 131072


@functools.lru_cache(maxsize=None)
def _zoom_tables(cfg: ChirpConfig, nfft: int):
    """Precomputed decimated templates + shifted-template refinement matrices.

    Coarse stage operates on a complex baseband decimated by _ZOOM_DECIM:
    mix by e^{-j w_c t} (band center), box-sum groups of D samples.  The
    box-sum is a linear filter, so correlating two box-filtered signals
    equals the true correlation smoothed by a 2D-1 tap triangle — the
    envelope peak location is preserved, and the refinement matmul restores
    exact full-rate timing and correlation values.
    """
    up_t, down_t, energy = _templates(cfg)
    D = _ZOOM_DECIM
    fc = (cfg.f_start + cfg.f_end) / 2.0
    n_t = cfg.chirp_samples
    rot_t = np.exp(-2j * np.pi * fc * np.arange(n_t) / cfg.sample_rate)
    nb = nfft // D

    def dec_tmpl(t):
        z = (t * rot_t)[: (n_t // D) * D].reshape(-1, D).sum(-1)
        return np.conj(np.fft.fft(z, nb)).astype(np.complex64)

    up_band = dec_tmpl(up_t)
    down_band = dec_tmpl(down_t)

    # Refinement matmul: M[n, j] = conj(t[n - j]) so (y @ M)[j] is the
    # correlation of window y against the template placed at offset j.
    R = _ZOOM_REFINE
    L = cfg.chirp_samples + 2 * R
    def shift_mat(t):
        M = np.zeros((L, 2 * R + 1), np.complex64)
        for j in range(2 * R + 1):
            M[j : j + cfg.chirp_samples, j] = np.conj(t)
        return np.ascontiguousarray(M.real), np.ascontiguousarray(M.imag)
    return up_band, down_band, energy, shift_mat(up_t), shift_mat(down_t)


def _refine_peak(x: jnp.ndarray, coarse_pos: jnp.ndarray, mats, tmpl_energy: float,
                 chirp_len: int):
    """Exact normalized correlation around a coarse peak (batched).

    x: [B, n]; coarse_pos: [B] int32.  Returns (lag [B] int32, corr [B]).
    """
    Mr, Mi = mats
    R = _ZOOM_REFINE
    L = chirp_len + 2 * R
    n = x.shape[-1]
    start = jnp.clip(coarse_pos - R, 0, n - L)
    y = jax.vmap(lambda a, s: jax.lax.dynamic_slice(a, (s,), (L,)))(x, start)
    cr = y @ jnp.asarray(Mr)
    ci = y @ jnp.asarray(Mi)
    mag2 = cr * cr + ci * ci                       # [B, 2R+1]
    csum = jnp.concatenate(
        [jnp.zeros(y.shape[:-1] + (1,), y.dtype), jnp.cumsum(y * y, axis=-1)], -1)
    win = csum[..., chirp_len : chirp_len + 2 * R + 1] - csum[..., : 2 * R + 1]
    win_floor = 1e-6 * jnp.max(win, axis=-1, keepdims=True)
    corr2 = mag2 / jnp.maximum(jnp.maximum(win, win_floor) * tmpl_energy, 1e-20)
    j = jnp.argmax(corr2, axis=-1).astype(jnp.int32)
    val = jnp.sqrt(jnp.take_along_axis(corr2, j[..., None], axis=-1)[..., 0])
    return start + j, val


def _detect_dual_chirp_zoom(samples: jnp.ndarray, cfg: ChirpConfig,
                            nfft: int) -> ChirpSyncResult:
    """Zoom-FFT dual-chirp search (large windows).  samples: [..., n]."""
    shape = samples.shape[:-1]
    n = samples.shape[-1]
    chirp_len = cfg.chirp_samples
    x = samples.reshape((-1, n)).astype(jnp.float32)
    up_band, down_band, energy, up_mats, down_mats = _zoom_tables(cfg, nfft)

    # Decimated complex baseband: mix by the band-center NCO (precomputed
    # ramp, shared across the batch) and box-sum groups of D samples — XLA
    # fuses mix+reshape+sum into one pass over the input, and every
    # subsequent transform is D times smaller than a full-rate FFT.
    D = _ZOOM_DECIM
    nb = nfft // D
    nblk_z = n // D
    fc = (cfg.f_start + cfg.f_end) / 2.0
    rot = jnp.asarray(np.exp(-2j * np.pi * fc * np.arange(nblk_z * D)
                             / cfg.sample_rate).astype(np.complex64))
    zb = (x[..., : nblk_z * D] * rot).reshape(x.shape[:-1] + (nblk_z, D)).sum(-1)
    Z = jnp.fft.fft(zb, nb)
    env_up = jnp.abs(jnp.fft.ifft(Z * jnp.asarray(up_band)))    # ~|c(mD)|
    env_down = jnp.abs(jnp.fft.ifft(Z * jnp.asarray(down_band)))

    # Normalize the coarse envelope by the sliding window energy at stride D
    # so the argmax matches the normalized-correlation argmax (signal energy
    # varies along the window: leading silence vs frame body).
    num_lags = n - chirp_len
    nm = nb
    # Window energy at stride-D lags only: block-sum x^2 by D (the dispatch
    # guarantees chirp_len % D == 0), then a D-times-shorter cumsum.  Exact
    # for these lags.
    nblk = n // D
    blk = jnp.sum((x[..., : nblk * D] * x[..., : nblk * D]).reshape(x.shape[:-1] + (nblk, D)), -1)
    csum = jnp.concatenate(
        [jnp.zeros(x.shape[:-1] + (1,), x.dtype), jnp.cumsum(blk, axis=-1)], -1)
    idx = jnp.arange(nm, dtype=jnp.int32) * D
    valid = idx < num_lags
    idx_b = jnp.minimum(idx // D, max(nblk - chirp_len // D - 1, 0))
    win = jnp.take(csum, idx_b + chirp_len // D, axis=-1) - jnp.take(csum, idx_b, axis=-1)
    # -60 dB energy floor (see _norm_correlate): silence windows holding
    # only numeric residue must not outscore the real peak.
    win_floor = 1e-6 * jnp.max(jnp.where(valid, win, 0.0), axis=-1, keepdims=True)
    inv = jax.lax.rsqrt(jnp.maximum(jnp.maximum(win, win_floor) * energy, 1e-20))

    up_env = jnp.where(valid, env_up * inv, -1.0)
    up_coarse = (jnp.argmax(up_env, axis=-1).astype(jnp.int32)) * D
    up_pos, up_val = _refine_peak(x, up_coarse, up_mats, energy, chirp_len)
    # CFAR floor: median normalized correlation over valid lags.
    up_med = jnp.nanmedian(jnp.where(valid, env_up * inv, jnp.nan), axis=-1)
    up_cfar = (up_val >= cfg.cfar_ratio * jnp.maximum(up_med, 1e-9)) \
        & (up_val >= cfg.cfar_abs_floor)

    if not cfg.use_dual_chirp:
        ok = (up_val >= cfg.threshold) | up_cfar
        res = ChirpSyncResult(ok, jnp.where(ok, up_pos, -1), jnp.zeros_like(up_val),
                              up_val, jnp.zeros_like(up_val))
        return ChirpSyncResult(*(v.reshape(shape) for v in res))

    lo = up_pos + chirp_len // 2
    hi = up_pos + chirp_len + cfg.gap_samples + 10000 + chirp_len
    mask = valid & (idx >= lo[..., None]) & (idx <= hi[..., None])
    down_env = jnp.where(mask, env_down * inv, -1.0)
    down_coarse = (jnp.argmax(down_env, axis=-1).astype(jnp.int32)) * D
    down_pos, down_val = _refine_peak(x, down_coarse, down_mats, energy, chirp_len)

    expected_gap = chirp_len + cfg.gap_samples
    gap_error = (down_pos - up_pos - expected_gap).astype(jnp.float32)
    cfo = gap_error / (2.0 * cfg.cfo_to_samples)

    strong = (up_val >= cfg.threshold) & (down_val >= cfg.threshold)
    cfar = up_cfar & (down_val >= cfg.cfar_down_floor)
    ok = (strong | cfar) & (jnp.abs(cfo) <= 100.0)
    start = jnp.round(up_pos.astype(jnp.float32) + cfo * cfg.cfo_to_samples).astype(jnp.int32)
    res = ChirpSyncResult(
        detected=ok,
        start=jnp.where(ok, start, -1),
        cfo_hz=jnp.where(ok, cfo, 0.0),
        up_corr=up_val,
        down_corr=down_val,
    )
    return ChirpSyncResult(*(v.reshape(shape) for v in res))


def _norm_correlate(x: jnp.ndarray, tmpl_fft: jnp.ndarray, tmpl_energy: float,
                    chirp_len: int, nfft: int) -> jnp.ndarray:
    """Normalized correlation magnitude for every lag (batched over leading axes)."""
    X = jnp.fft.fft(x.astype(jnp.complex64), nfft)
    corr = jnp.fft.ifft(X * tmpl_fft)
    energy = jnp.cumsum(jnp.square(x), axis=-1)
    zero = jnp.zeros(x.shape[:-1] + (1,), x.dtype)
    csum = jnp.concatenate([zero, energy], axis=-1)
    n = x.shape[-1]
    num_lags = n - chirp_len
    win = csum[..., chirp_len : chirp_len + num_lags] - csum[..., :num_lags]
    # Energy floor: windows holding only numeric residue of silence (e.g.
    # FFT leakage after a frequency shift) must not win the argmax through
    # a vanishing denominator — require at least -60 dB of the loudest
    # window before a lag can compete.
    win_floor = 1e-6 * jnp.max(win, axis=-1, keepdims=True)
    denom = jnp.sqrt(jnp.maximum(jnp.maximum(win, win_floor) * tmpl_energy, 1e-20))
    return jnp.abs(corr[..., :num_lags]) / denom


@functools.partial(jax.jit, static_argnames=("cfg", "num_samples"))
def detect_dual_chirp(samples: jnp.ndarray, cfg: ChirpConfig, num_samples: int | None = None) -> ChirpSyncResult:
    """Detect the dual-chirp preamble in a (fixed-size) sample window.

    Returns per-window results; vmap over a leading batch axis for
    multi-channel search.  `num_samples` defaults to samples.shape[-1]
    (static under jit).
    """
    del num_samples
    n = samples.shape[-1]
    chirp_len = cfg.chirp_samples
    if n < cfg.total_samples + 64:
        # Window cannot hold the dual-chirp sequence (static shape check).
        shape = samples.shape[:-1]
        f = jnp.zeros(shape, jnp.float32)
        return ChirpSyncResult(jnp.zeros(shape, bool), jnp.full(shape, -1, jnp.int32),
                               f, f, f)
    nfft = _next_pow2(n + chirp_len)
    if nfft >= _ZOOM_MIN_NFFT and chirp_len % _ZOOM_DECIM == 0:
        return _detect_dual_chirp_zoom(samples, cfg, nfft)
    up_t, down_t, energy = _templates(cfg)
    up_fft = jnp.conj(jnp.fft.fft(jnp.asarray(up_t), nfft))
    down_fft = jnp.conj(jnp.fft.fft(jnp.asarray(down_t), nfft))

    up_corr = _norm_correlate(samples, up_fft, energy, chirp_len, nfft)
    num_lags = up_corr.shape[-1]
    up_pos = jnp.argmax(up_corr, axis=-1).astype(jnp.int32)
    up_val = jnp.take_along_axis(up_corr, up_pos[..., None], axis=-1)[..., 0]
    up_med = jnp.median(up_corr, axis=-1)
    up_cfar = (up_val >= cfg.cfar_ratio * jnp.maximum(up_med, 1e-9)) \
        & (up_val >= cfg.cfar_abs_floor)

    if not cfg.use_dual_chirp:
        ok = (up_val >= cfg.threshold) | up_cfar
        return ChirpSyncResult(ok, jnp.where(ok, up_pos, -1), jnp.zeros_like(up_val),
                               up_val, jnp.zeros_like(up_val))

    # Down-chirp: correlate everywhere, then mask to the window the reference
    # searches ([up+chirp/2, up+chirp+gap+10000+chirp]).
    down_corr = _norm_correlate(samples, down_fft, energy, chirp_len, nfft)
    lags = jnp.arange(num_lags, dtype=jnp.int32)
    lo = up_pos + chirp_len // 2
    hi = up_pos + chirp_len + cfg.gap_samples + 10000 + chirp_len
    mask = (lags >= lo[..., None]) & (lags <= hi[..., None])
    down_masked = jnp.where(mask, down_corr, -1.0)
    down_pos = jnp.argmax(down_masked, axis=-1).astype(jnp.int32)
    down_val = jnp.take_along_axis(down_masked, down_pos[..., None], axis=-1)[..., 0]

    expected_gap = chirp_len + cfg.gap_samples
    gap_error = (down_pos - up_pos - expected_gap).astype(jnp.float32)
    cfo = gap_error / (2.0 * cfg.cfo_to_samples)

    strong = (up_val >= cfg.threshold) & (down_val >= cfg.threshold)
    cfar = up_cfar & (down_val >= cfg.cfar_down_floor)
    ok = (strong | cfar) & (jnp.abs(cfo) <= 100.0)
    start = jnp.round(up_pos.astype(jnp.float32) + cfo * cfg.cfo_to_samples).astype(jnp.int32)
    return ChirpSyncResult(
        detected=ok,
        start=jnp.where(ok, start, -1),
        cfo_hz=jnp.where(ok, cfo, 0.0),
        up_corr=up_val,
        down_corr=down_val,
    )
