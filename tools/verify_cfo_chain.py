"""CFO-chain verification (reference tools/verify_cfo_chain_dump.py).

The reference dumps pre/post CFO-correction baseband (.cf32) and estimates
the applied phase slope.  Here the equivalent check runs end to end: inject
a known CFO, run the sync estimator + demod CFO-correction path, dump the
pre/post analytic baseband, and verify the measured phase slope equals the
applied correction.

Usage: python tools/verify_cfo_chain.py [--cfo 12.0] [--dump-prefix /tmp/cfo]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np


def phase_slope_hz(z: np.ndarray, sample_rate: float = 48000.0) -> float:
    """Average frequency of a complex baseband signal from its phase slope."""
    d = z[1:] * np.conj(z[:-1])
    return float(np.angle(np.sum(d)) * sample_rate / (2 * np.pi))


def main():
    import jax.numpy as jnp

    from ria_tpu.dsp.hilbert import analytic_signal
    from ria_tpu.sync.chirp import detect_dual_chirp
    from ria_tpu.wave.mc_dpsk import MCDPSKConfig, modulate, preamble

    ap = argparse.ArgumentParser()
    ap.add_argument("--cfo", type=float, default=12.0)
    ap.add_argument("--dump-prefix", default=None)
    args = ap.parse_args()

    cfg = MCDPSKConfig()
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 648)
    from ria_tpu.dsp.nco import freq_shift_real

    clean = np.concatenate([preamble(cfg), modulate(bits, cfg)])
    shifted, _ = freq_shift_real(jnp.asarray(clean), args.cfo, cfg.sample_rate)
    audio = np.concatenate([np.zeros(4000, np.float32),
                            np.asarray(shifted, np.float32),
                            np.zeros(4000, np.float32)])
    audio += rng.normal(0, 0.02, audio.shape).astype(np.float32)

    sync = detect_dual_chirp(jnp.asarray(audio), cfg.chirp)
    est = float(sync.cfo_hz)
    print(f"applied CFO: {args.cfo:+.2f} Hz   dual-chirp estimate: {est:+.2f} Hz")

    # Pre/post-correction baseband: carrier-0 symbol-integrated phasors over
    # the training symbols (carrier 0's training phase is constant, and the
    # symbol integration rejects the other carriers).
    start = int(sync.start) + cfg.chirp.total_samples
    sps = cfg.samples_per_symbol
    span = audio[start : start + cfg.training_symbols * sps]
    z = np.asarray(analytic_signal(jnp.asarray(span)))
    f0 = cfg.carrier_freqs[0]
    t = np.arange(len(z)) / cfg.sample_rate
    pre = z * np.exp(-2j * np.pi * f0 * t)
    post = pre * np.exp(-2j * np.pi * est * t)

    if args.dump_prefix:
        pre.astype(np.complex64).tofile(args.dump_prefix + "_pre.cf32")
        post.astype(np.complex64).tofile(args.dump_prefix + "_post.cf32")
        print(f"dumped {args.dump_prefix}_pre.cf32 / _post.cf32")

    slope_pre = phase_slope_hz(pre)
    slope_post = phase_slope_hz(post)
    applied = slope_pre - slope_post
    print(f"phase slope pre-correction:  {slope_pre:+.2f} Hz")
    print(f"phase slope post-correction: {slope_post:+.2f} Hz")
    print(f"applied correction (pre-post): {applied:+.2f} Hz (expect {est:+.2f})")
    ok = abs(est - args.cfo) < 3.0 and abs(applied - est) < 0.5
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
