"""Multi-device scaling of the sharded RX pipeline.

Runs the (ch x cw)-sharded batch RX step on 1/2/4/8 devices and reports
throughput.  On a real pod slice each device is a chip and the numbers give
scaling efficiency; on a single host with
--xla_force_host_platform_device_count the run validates that the sharded
program compiles + executes and that work distributes (absolute CPU numbers
are not chip numbers).

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/scaling_bench.py
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import time

import numpy as np


def stream_main():
    """Strong scaling of the time-block stream RX (parallel/stream.py): a
    fixed 16 s production-geometry stream is sharded over 1/2/4/8 devices;
    ideal scaling = wall time / n.  Efficiency < 1 reflects the halo overlap
    (each device re-searches one preamble length of its neighbor) plus the
    collectives."""
    import time

    import jax

    from ria_tpu.fec.ldpc import make_encoder
    from ria_tpu.fec.ldpc_matrix import get_code
    from ria_tpu.parallel.stream import make_stream_mesh, make_stream_rx
    from ria_tpu.wave.mc_dpsk import MCDPSKConfig, modulate, preamble

    cfg = MCDPSKConfig(num_carriers=10, bits_per_symbol=1)
    ncw, total = 4, 8 * 96000
    rng = np.random.default_rng(0)
    code = get_code("R1_4")
    info = rng.integers(0, 2, (ncw, code.k)).astype(np.uint8)
    coded = np.asarray(make_encoder("R1_4")(info)).reshape(-1)
    tx = np.concatenate([preamble(cfg), modulate(coded, cfg)])
    stream = np.zeros(total, np.float32)
    pos = 150000
    stream[pos : pos + len(tx)] = tx
    rms = float(np.sqrt(np.mean(tx**2)))
    stream += rng.normal(0, rms * 10 ** (-10 / 20), total).astype(np.float32)

    n_avail = len(jax.devices())
    print(f"stream strong scaling: {total/48000:.0f}s audio, "
          f"frame={len(tx)} samples ({jax.devices()[0].platform})")
    base_dt = None
    n = 1
    while n <= n_avail:
        block = total // n
        mesh = make_stream_mesh(n)
        rx = make_stream_rx(mesh, cfg, "R1_4", ncw, block)
        out = rx(stream)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        iters = 5
        for _ in range(iters):
            out = rx(stream)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        sps = total / dt
        if base_dt is None:
            base_dt = dt
        eff = base_dt / (n * dt)  # strong scaling: ideal = 1.0
        ok = float(np.asarray(out["cw_success"]).mean())
        print(f"devices={n}  block={block}  {dt*1e3:8.2f} ms"
              f"  {sps/1e6:8.1f} Msamp/s  strong-eff={eff:5.2f}  decode={ok:.2f}")
        n *= 2


def ofdm_stream_main():
    """Strong scaling of the sequence-parallel OFDM stream RX
    (parallel/stream.py make_ofdm_stream_rx), mirroring stream_main."""
    import time

    import jax

    from ria_tpu.fec.ldpc_matrix import get_code
    from ria_tpu.parallel.stream import make_ofdm_stream_rx, make_stream_mesh
    from ria_tpu.phy.frame_v2 import encode_fixed_frame
    from ria_tpu.wave.ofdm import OFDMConfig, tx_frame

    cfg = OFDMConfig(modulation="DQPSK", use_pilots=False)
    rate = "R1_2"
    ci = cfg.bits_per_ofdm_symbol()
    total = 8 * 65536   # ~10.9 s: keeps the ~11k-sample search halo small
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, 4 * (get_code(rate).k // 8)).astype(np.uint8).tobytes()
    tx = np.asarray(tx_frame(encode_fixed_frame(payload, rate, ci), cfg,
                             preamble="cox"), np.float32)
    stream = np.zeros(total, np.float32)
    pos = 3 * 65536 - 3000
    stream[pos : pos + len(tx)] = tx
    rms = float(np.sqrt(np.mean(tx**2)))
    stream += rng.normal(0, rms * 10 ** (-15 / 20), total).astype(np.float32)

    n_avail = len(jax.devices())
    print(f"OFDM stream strong scaling: {total/48000:.1f}s audio "
          f"({jax.devices()[0].platform})")
    base_dt = None
    n = 1
    while n <= n_avail:
        block = total // n
        mesh = make_stream_mesh(n)
        try:
            rx = make_ofdm_stream_rx(mesh, cfg, rate, block, ci)
        except AssertionError as e:
            print(f"devices={n}: skipped ({e})")
            n *= 2
            continue
        out = rx(stream)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        iters = 5
        for _ in range(iters):
            out = rx(stream)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        if base_dt is None:
            base_dt = dt
        eff = base_dt / (n * dt)
        ok = float(np.asarray(out["cw_success"]).mean())
        print(f"devices={n}  block={block}  {dt*1e3:8.2f} ms"
              f"  {total/dt/1e6:8.1f} Msamp/s  strong-eff={eff:5.2f}  decode={ok:.2f}")
        n *= 2


def main():
    import jax

    from ria_tpu.parallel.mesh import make_mesh, make_sharded_rx
    from ria_tpu.sync.chirp import ChirpConfig
    from ria_tpu.wave.mc_dpsk import MCDPSKConfig
    from ria_tpu.fec.ldpc import make_encoder
    from ria_tpu.fec.ldpc_matrix import get_code
    from ria_tpu.phy.pipeline import make_tx_pipeline

    n_avail = len(jax.devices())
    print(f"devices available: {n_avail} ({jax.devices()[0].platform})")

    # Small geometry on CPU meshes (compile cost); pass --full on real chips.
    import sys

    full = "--full" in sys.argv
    if full:
        cfg = MCDPSKConfig(num_carriers=10, bits_per_symbol=1)
        ncw, per_dev = 4, 16
    else:
        chirp = ChirpConfig(duration_ms=10.0, gap_ms=2.0)
        cfg = MCDPSKConfig(num_carriers=4, samples_per_symbol=128,
                           bits_per_symbol=2, training_symbols=4, chirp=chirp)
        ncw, per_dev = 2, 8
    nb = ncw * 648
    window = cfg.frame_samples(nb) + 4000

    rng = np.random.default_rng(0)
    code = get_code("R1_4")

    results = []
    n = 1
    while n <= n_avail:
        B = per_dev * n
        info = rng.integers(0, 2, (B * ncw, code.k)).astype(np.uint8)
        coded = np.asarray(make_encoder("R1_4")(info)).reshape(B, nb)
        tx = np.asarray(make_tx_pipeline(cfg, ncw)(coded))
        audio = np.zeros((B, window), np.float32)
        audio[:, 1000 : 1000 + tx.shape[1]] = tx[:, : window - 1000]
        rms = float(np.sqrt(np.mean(tx**2)))
        audio += rng.normal(0, rms * 10 ** (-10 / 20), audio.shape).astype(np.float32)

        mesh = make_mesh(n)
        rx = make_sharded_rx(mesh, cfg, "R1_4", ncw, window)
        with mesh:
            out = rx(audio)
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            iters = 5
            for _ in range(iters):
                out = rx(audio)
            jax.block_until_ready(out)
            dt = (time.perf_counter() - t0) / iters
        sps = B * window / dt
        ok = float(np.asarray(out.cw_success).mean())
        results.append((n, sps))
        eff = sps / (results[0][1] * n) if results[0][1] else 0.0
        print(f"devices={n}  batch={B}  {dt*1e3:8.2f} ms  {sps/1e6:8.1f} Msamp/s  "
              f"scaling-eff={eff:5.2f}  decode={ok:.2f}")
        n *= 2


if __name__ == "__main__":
    if "--stream" in _sys.argv:
        stream_main()
    elif "--ofdm-stream" in _sys.argv:
        ofdm_stream_main()
    else:
        main()
