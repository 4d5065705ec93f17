"""Acquisition/decode latency profiler (reference tools/profile_acquisition.cpp).

Measures, per waveform: sync search latency over a realistic window, frame
demod latency, and LDPC decode latency — wall time per call on the active
JAX backend (the GPU when there is one).

Usage: python tools/profile_acquisition.py [--batch 32]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import numpy as np


def _time(fn, make_arg, iters=12, nbuf=4):
    """Pipelined timing over distinct device buffers, blocking once."""
    import jax

    bufs = [jax.device_put(make_arg()) for _ in range(nbuf)]
    outs = [fn(b) for b in bufs]
    jax.block_until_ready(outs)
    t0 = time.perf_counter()
    outs = [fn(bufs[i % nbuf]) for i in range(iters)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / iters


def main():
    import jax
    import jax.numpy as jnp

    from ria_tpu.fec.ldpc import make_decoder
    from ria_tpu.sync.chirp import detect_dual_chirp
    from ria_tpu.sync.zc import ZCConfig, detect as zc_detect
    from ria_tpu.wave.mc_dpsk import MCDPSKConfig, demodulate
    from ria_tpu.wave.ofdm import OFDMConfig, demodulate_presynced, schmidl_cox_search

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    B = args.batch
    rng = np.random.default_rng(0)

    print(f"device: {jax.devices()[0]}  batch: {B}")

    # Chirp search over a 120k-sample window (reference search budget).
    mc = MCDPSKConfig()
    dt = _time(lambda x: detect_dual_chirp(x, mc.chirp),
               lambda: rng.normal(0, 0.1, (B, 120000)).astype(np.float32))
    print(f"chirp sync   120k window x{B}: {dt*1e3:8.2f} ms  "
          f"({B*120000/dt/1e6:8.1f} Msamp/s)")

    # ZC search over a 48k connected-mode window.
    mk48 = lambda: rng.normal(0, 0.1, (B, 48000)).astype(np.float32)
    dt = _time(lambda x: zc_detect(x, ZCConfig()), mk48)
    print(f"ZC sync       48k window x{B}: {dt*1e3:8.2f} ms  "
          f"({B*48000/dt/1e6:8.1f} Msamp/s)")

    # MC-DPSK demod: 4-CW frame.
    nsym = mc.num_data_symbols(4 * 648)
    need = (mc.training_symbols + 1 + nsym) * mc.samples_per_symbol
    cfo = jnp.zeros(B)
    mkf = lambda n=need: rng.normal(0, 0.1, (B, n)).astype(np.float32)
    dt = _time(lambda f: demodulate(f, cfo, mc, nsym), mkf)
    print(f"mc-dpsk demod 4-CW frame x{B}: {dt*1e3:8.2f} ms")

    # OFDM demod: 4-CW DQPSK frame.
    of = OFDMConfig()
    S = of.num_symbols_for_bits(4 * 648)
    need = (2 + S) * of.symbol_samples
    mko = lambda n=need: rng.normal(0, 0.1, (B, n)).astype(np.float32)
    dt = _time(lambda f: demodulate_presynced(f, cfo, of, S, 2), mko)
    print(f"ofdm demod    4-CW frame x{B}: {dt*1e3:8.2f} ms")

    # Schmidl-Cox search.
    dt = _time(lambda x: schmidl_cox_search(x, of), mk48)
    print(f"schmidl-cox   48k window x{B}: {dt*1e3:8.2f} ms")

    # LDPC decode.
    dec = make_decoder("R1_4")
    dt = _time(dec, lambda: rng.normal(0, 4, (B * 4, 648)).astype(np.float32))
    print(f"ldpc R1/4     {B*4} cw (noise): {dt*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
