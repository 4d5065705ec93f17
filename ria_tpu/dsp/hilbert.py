"""FFT-based analytic signal (zero-group-delay Hilbert transform).

The reference uses a windowed-sinc FIR Hilbert in the modem path and an
FFT-based transform in its test harness (reference: src/sync/chirp_sync.hpp
notes "FFT-based Hilbert transform which has NO group delay").  On an
accelerator the FFT form is both faster and simpler, so it is used
everywhere; CFO rotation then happens on the complex baseband.
"""

from __future__ import annotations

import jax.numpy as jnp


def analytic_signal(x: jnp.ndarray) -> jnp.ndarray:
    """Real [..., N] -> complex analytic signal [..., N] (batched, jittable).

    Standard construction: double positive frequencies, zero negatives.

    Computed on a power-of-two length, the size every FFT library serves
    fastest (the sync-search windows, e.g. 42720 samples, are not
    smooth sizes).  Zero-padding a FINITE window changes the analytic
    signal only by the wrap-around leakage the rectangular window already
    causes, and every consumer here (SC metric, chirp correlators)
    normalizes per-lag energy, so the numerical difference is noise-level;
    the edge samples beyond the original length are discarded.
    """
    n = x.shape[-1]
    nfft = 1 << (n - 1).bit_length()
    X = jnp.fft.fft(x, n=nfft, axis=-1)
    h = jnp.zeros(nfft, dtype=x.dtype)
    h = h.at[0].set(1.0).at[nfft // 2].set(1.0).at[1 : nfft // 2].set(2.0)
    return jnp.fft.ifft(X * h, axis=-1)[..., :n]
