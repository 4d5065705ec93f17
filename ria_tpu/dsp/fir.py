"""FIR design (host numpy) + batched FFT-based filtering (jitted).

Tap design matches the reference windowed-sinc formulas
(reference: src/dsp/filters.cpp:20-77): Hamming-windowed normalized lowpass,
spectral-inversion highpass, Blackman-windowed bandpass.  Filtering itself is
redesigned as array code: instead of a stateful per-sample delay line, blocks are
convolved via FFT (overlap handled by the caller passing a `tail` carry),
batched over leading axes.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def design_lowpass(taps: int, cutoff: float, sample_rate: float) -> np.ndarray:
    fc = cutoff / sample_rate
    M = (taps - 1) // 2
    n = np.arange(taps)
    x = np.pi * (n - M)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(n == M, 2.0 * fc, np.sin(2.0 * fc * x) / x)
    h *= 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (taps - 1))
    return (h / h.sum()).astype(np.float32)


def design_highpass(taps: int, cutoff: float, sample_rate: float) -> np.ndarray:
    h = -design_lowpass(taps, cutoff, sample_rate)
    h[(taps - 1) // 2] += 1.0
    return h.astype(np.float32)


def design_bandpass(taps: int, low: float, high: float, sample_rate: float) -> np.ndarray:
    fl, fh = low / sample_rate, high / sample_rate
    M = (taps - 1) // 2
    n = np.arange(taps)
    x = np.pi * (n - M)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(n == M, 2.0 * (fh - fl), (np.sin(2.0 * fh * x) - np.sin(2.0 * fl * x)) / x)
    w = 2.0 * np.pi * n / (taps - 1)
    h *= 0.42 - 0.5 * np.cos(w) + 0.08 * np.cos(2.0 * w)
    return h.astype(np.float32)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def fft_convolve(x: jnp.ndarray, h: jnp.ndarray, mode: str = "same") -> jnp.ndarray:
    """Linear convolution along the last axis via FFT (batched, jittable).

    mode="same" returns len(x) samples aligned like a causal FIR with its
    group delay removed handled by the caller; here "same" means centered
    like np.convolve(mode="same"); "full" returns len(x)+len(h)-1.
    """
    n = x.shape[-1] + h.shape[-1] - 1
    nfft = _next_pow2(n)
    X = jnp.fft.rfft(x, nfft)
    H = jnp.fft.rfft(h, nfft)
    y = jnp.fft.irfft(X * H, nfft)[..., :n]
    if mode == "full":
        return y
    if mode == "same":
        start = (h.shape[-1] - 1) // 2
        return y[..., start : start + x.shape[-1]]
    raise ValueError(mode)


def fir_filter(x: jnp.ndarray, h: jnp.ndarray, tail: jnp.ndarray | None = None):
    """Causal streaming FIR over a block: returns (y, new_tail).

    Equivalent to feeding the samples through a stateful delay-line FIR
    (reference src/dsp/filters.cpp:79-104): y[i] = sum_k h[k] x[i-k], with
    history carried in `tail` ([..., len(h)-1] previous input samples).
    """
    taps = h.shape[-1]
    if tail is None:
        tail = jnp.zeros(x.shape[:-1] + (taps - 1,), x.dtype)
    xx = jnp.concatenate([tail, x], axis=-1)
    y = fft_convolve(xx, h, mode="full")[..., taps - 1 : taps - 1 + x.shape[-1]]
    new_tail = xx[..., -(taps - 1) :]
    return y, new_tail
