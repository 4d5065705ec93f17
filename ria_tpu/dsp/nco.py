"""NCO / mixing as vectorized phase ramps (no per-sample state).

Replaces the reference's per-sample NCO object (include/ultra/dsp.hpp:160-181)
with batched phase-ramp construction; streaming phase continuity is carried
explicitly by the caller as a scalar start phase.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def phase_ramp(freq_hz, num_samples: int, sample_rate: float, start_phase=0.0) -> jnp.ndarray:
    """Phase ramp(s) [samples] or [..., samples] for scalar/array freq."""
    t = jnp.arange(num_samples, dtype=jnp.float32)
    freq = jnp.asarray(freq_hz, dtype=jnp.float32)
    return jnp.asarray(start_phase, jnp.float32)[..., None] + (
        2.0 * jnp.pi * freq[..., None] / sample_rate
    ) * t


def mixer_bank(freqs_hz: np.ndarray, num_samples: int, sample_rate: float) -> np.ndarray:
    """Complex mixer bank e^{-j 2 pi f t} of shape [num_samples, num_freqs].

    Host-side constant: multiplying a [symbols, samples] block by this matrix
    performs mix-and-integrate demodulation for every carrier at once on
    the matrix units (the array form of the reference's per-carrier loop,
    src/psk/multi_carrier_dpsk.hpp:931-946).
    """
    t = np.arange(num_samples, dtype=np.float64)[:, None]
    f = np.asarray(freqs_hz, dtype=np.float64)[None, :]
    return np.exp(-2j * np.pi * f * t / sample_rate).astype(np.complex64)


def freq_shift_real(x: jnp.ndarray, shift_hz: float, sample_rate: float, start_phase=0.0):
    """Shift a real signal's spectrum by shift_hz via analytic signal rotation.

    Returns (shifted_real, end_phase).  Used for CFO correction; matches the
    reference's Hilbert+rotate approach (src/psk/multi_carrier_dpsk.hpp:897-926)
    but with the zero-delay FFT Hilbert.
    """
    from ria_tpu.dsp.hilbert import analytic_signal

    z = analytic_signal(x)
    ph = phase_ramp(shift_hz, x.shape[-1], sample_rate, start_phase)
    rot = jnp.exp(1j * ph)
    end_phase = ph[..., -1] + 2.0 * jnp.pi * shift_hz / sample_rate
    return jnp.real(z * rot), end_phase
