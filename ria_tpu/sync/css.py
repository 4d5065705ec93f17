"""CSS (chirp spread spectrum) sync with cyclic-shift frame typing.

Contract from the reference (src/sync/css_sync.hpp):
- single base up-chirp 300->2700 Hz over 500 ms, repeated num_chirps=2 with
  100 ms gaps; frame type in 1-of-4 cyclic shift of the chirp (PING=0,
  PONG=1, DATA=2, CONTROL=3), shifts evenly spaced over the duration;
- detection: matched-filter position search, then dechirp (multiply by
  conjugate base chirp) + FFT — the peak bin reveals the cyclic shift.

Array form: matched filter for all 4 shifted templates at once (batched FFT
correlation like ria_tpu.sync.chirp), frame type from the argmax template.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

CSS_PING, CSS_PONG, CSS_DATA, CSS_CONTROL, CSS_UNKNOWN = 0, 1, 2, 3, 255


@dataclass(frozen=True)
class CSSConfig:
    sample_rate: float = 48000.0
    f_start: float = 300.0
    f_end: float = 2700.0
    duration_ms: float = 500.0
    gap_ms: float = 100.0
    num_shifts: int = 4
    num_chirps: int = 2
    threshold: float = 0.3

    @property
    def chirp_samples(self) -> int:
        return int(self.sample_rate * self.duration_ms / 1000.0)

    @property
    def gap_samples(self) -> int:
        return int(self.sample_rate * self.gap_ms / 1000.0)

    @property
    def preamble_samples(self) -> int:
        return (self.num_chirps * self.chirp_samples
                + (self.num_chirps - 1) * self.gap_samples + self.gap_samples)


@functools.lru_cache(maxsize=None)
def _base_phase(cfg: CSSConfig) -> np.ndarray:
    t = np.arange(cfg.chirp_samples, dtype=np.float64) / cfg.sample_rate
    k = (cfg.f_end - cfg.f_start) / (cfg.duration_ms / 1000.0)
    return 2.0 * np.pi * (cfg.f_start * t + 0.5 * k * t * t)


@functools.lru_cache(maxsize=None)
def _shifted_chirp(cfg: CSSConfig, shift: int) -> np.ndarray:
    """Real chirp cyclically shifted by shift/num_shifts of its duration."""
    base = np.sin(_base_phase(cfg)).astype(np.float32)
    off = (shift * cfg.chirp_samples) // cfg.num_shifts
    return np.roll(base, off)


@functools.lru_cache(maxsize=None)
def _shifted_template(cfg: CSSConfig, shift: int) -> np.ndarray:
    """Analytic template of the WHOLE preamble (both chirp repeats + gap).

    Matching one chirp at a time is ambiguous two ways: the correlator
    peaks equally at either repeat (locking one chirp+gap late), and a
    partially-visible shifted chirp aliases into a different (shift,
    position) pair — a cyclic shift IS a wrapped time shift.  The full
    two-chirp template has a unique global peak.
    """
    analytic = np.exp(1j * _base_phase(cfg)).astype(np.complex64)
    off = (shift * cfg.chirp_samples) // cfg.num_shifts
    one = np.roll(analytic, off)
    gap = np.zeros(cfg.gap_samples, np.complex64)
    parts = []
    for i in range(cfg.num_chirps):
        parts.append(one)
        if i < cfg.num_chirps - 1:
            parts.append(gap)
    return np.concatenate(parts)


def generate_preamble(cfg: CSSConfig, frame_type: int, amplitude: float = 0.5) -> np.ndarray:
    shift = frame_type if 0 <= frame_type < cfg.num_shifts else CSS_DATA
    chirp = amplitude * _shifted_chirp(cfg, shift)
    gap = np.zeros(cfg.gap_samples, np.float32)
    parts = []
    for i in range(cfg.num_chirps):
        parts.append(chirp)
        parts.append(gap)
    return np.concatenate(parts).astype(np.float32)


class CSSResult(NamedTuple):
    detected: jnp.ndarray
    frame_type: jnp.ndarray
    start_sample: jnp.ndarray  # data start (after preamble)
    correlation: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect(samples: jnp.ndarray, cfg: CSSConfig) -> CSSResult:
    n = samples.shape[-1]
    L = len(_shifted_template(cfg, 0))          # full two-chirp span
    if n < cfg.preamble_samples + 64:
        shape = samples.shape[:-1]
        return CSSResult(jnp.zeros(shape, bool), jnp.full(shape, CSS_UNKNOWN, jnp.int32),
                         jnp.full(shape, -1, jnp.int32), jnp.zeros(shape, jnp.float32))
    nfft = 1 << (n + L - 1).bit_length()
    num_lags = max(n - L, 1)

    X = jnp.fft.fft(samples.astype(jnp.complex64), nfft)
    tmpl = np.stack([_shifted_template(cfg, s) for s in range(cfg.num_shifts)])
    T = jnp.conj(jnp.fft.fft(jnp.asarray(tmpl), nfft, axis=-1))
    corr = jnp.abs(jnp.fft.ifft(X[..., None, :] * T, axis=-1))[..., :num_lags]

    e = jnp.cumsum(jnp.square(samples.astype(jnp.float32)), axis=-1)
    zero = jnp.zeros(samples.shape[:-1] + (1,), jnp.float32)
    cs = jnp.concatenate([zero, e], axis=-1)
    win = cs[..., L : L + num_lags] - cs[..., :num_lags]
    # Relative energy floor: a near-silent lag window must not spike the
    # normalized metric (a noise-only denominator under a tiny numerator
    # reads as a detection and skips the real preamble further on).
    win = jnp.maximum(win, 0.02 * jnp.max(win, axis=-1, keepdims=True))
    energy = float(np.sum(np.abs(_shifted_template(cfg, 0)) ** 2) / 2.0)
    norm = corr / jnp.sqrt(jnp.maximum(win[..., None, :] * energy, 1e-20))

    flat = norm.reshape(norm.shape[:-2] + (-1,))
    best = jnp.argmax(flat, axis=-1)
    shift = (best // num_lags).astype(jnp.int32)
    pos = (best % num_lags).astype(jnp.int32)
    val = jnp.take_along_axis(flat, best[..., None], -1)[..., 0]
    detected = val > cfg.threshold
    return CSSResult(
        detected=detected,
        frame_type=jnp.where(detected, shift, CSS_UNKNOWN).astype(jnp.int32),
        start_sample=jnp.where(detected, pos + cfg.preamble_samples, -1),
        correlation=val,
    )
