"""Benchmark: full RX chain throughput on one GPU — all three workhorses.

Chain 1 (headline metric): MC-DPSK — dual-chirp sync search + CFO estimation
(zoom FFT matched filter), mixer-bank demodulation, batched LDPC min-sum
decode (4 codewords/frame, R1/4) at 10 dB AWGN.

Chain 2 (detail): OFDM DQPSK R1/2 at 15 dB (north-star config #3) —
Schmidl-Cox search, CP strip + 1024-pt FFT, LTS channel estimate, MMSE
equalization, soft demap, frame/channel deinterleave, batched LDPC.

Chain 3 (detail): coherent OFDM-COX QAM64 R3/4 at 25 dB (config #4).

Prints the card's name and power limit, then ONE JSON line: samples/s
through the MC-DPSK RX chain per card; vs_baseline is the multiple of
real-time (48 kHz audio) sustained, i.e. how many live HF channels one card
can decode concurrently (the reference C++ decoder runs ~1 channel per core
in real time; north star is >=100x).  The other chains and the LDPC rows
ride in `detail`.  Needs a GPU: exits non-zero without one.

Usage: python bench.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Any, Callable, NamedTuple

import numpy as np


class Case(NamedTuple):
    """One RX chain at its production geometry: the jitted pipeline, seeded
    input windows [B, window] made through the TX path, and its config."""
    rx: Callable
    audio: np.ndarray
    cfg: Any
    rate: str
    ci_bits: int | None


def require_gpu():
    """jax.devices() when the default backend is a GPU; exit(2) otherwise
    (a measurement never falls back to the CPU)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX's default backend is {devs[0].platform!r}",
              file=sys.stderr)
        sys.exit(2)
    return devs


def card_info() -> str:
    """`name, power.limit` of each card, read by nvidia-smi in a child
    process that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_calls(fn, variants, iters: int) -> list[float]:
    """Seconds per call: one warm-up call per input, then `iters` calls
    that each end in block_until_ready."""
    import jax

    for v in variants:
        jax.block_until_ready(fn(v))
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(variants[i % len(variants)]))
        times.append(time.perf_counter() - t0)
    return times


def mc_dpsk_case(rng) -> Case:
    """The production MC-DPSK chain: 10-carrier DBPSK, R1/4, fixed 4-CW data
    frame, 10 dB AWGN, B=64."""
    from ria_tpu.fec.ldpc import make_encoder
    from ria_tpu.fec.ldpc_matrix import get_code
    from ria_tpu.phy.pipeline import make_rx_pipeline, make_tx_pipeline
    from ria_tpu.wave.mc_dpsk import MCDPSKConfig

    cfg = MCDPSKConfig(num_carriers=10, bits_per_symbol=1)
    ncw = 4
    num_bits = ncw * 648
    batch = 64
    window = cfg.frame_samples(num_bits) + 12000  # frame + search slack

    code = get_code("R1_4")
    info = rng.integers(0, 2, size=(batch * ncw, code.k)).astype(np.uint8)
    coded = np.asarray(make_encoder("R1_4")(info)).reshape(batch, num_bits)
    tx = np.asarray(make_tx_pipeline(cfg, ncw)(coded))
    audio = np.zeros((batch, window), np.float32)
    for b in range(batch):
        lead = int(rng.integers(0, 8000))
        n = min(tx.shape[1], window - lead)
        audio[b, lead : lead + n] = tx[b, :n]
    # 10 dB AWGN so the decoder does real iteration work.
    sig_rms = float(np.sqrt(np.mean(tx**2)))
    audio += rng.normal(0, sig_rms * 10 ** (-10 / 20), audio.shape).astype(np.float32)
    return Case(make_rx_pipeline(cfg, "R1_4", ncw, window), audio, cfg,
                "R1_4", None)


def _ofdm_audio(rng, cfg, rate, ci, batch, slack, max_lead, snr_db):
    from ria_tpu.fec.ldpc_matrix import get_code
    from ria_tpu.phy.frame_v2 import encode_fixed_frame
    from ria_tpu.wave.ofdm import tx_frame

    bpc = get_code(rate).k // 8
    S = cfg.num_symbols_for_bits(4 * 648)
    window = cfg.preamble_samples + (2 + S) * cfg.symbol_samples + slack
    audio = np.zeros((batch, window), np.float32)
    rms = None
    for b in range(batch):
        payload = rng.integers(0, 256, 4 * bpc).astype(np.uint8).tobytes()
        tx = tx_frame(encode_fixed_frame(payload, rate, ci), cfg, preamble="cox")
        lead = int(rng.integers(0, max_lead))
        audio[b, lead : lead + len(tx)] = tx
        rms = float(np.sqrt(np.mean(tx**2)))
    audio += rng.normal(0, rms * 10 ** (-snr_db / 20), audio.shape).astype(np.float32)
    return audio


def ofdm_case(rng) -> Case:
    """North-star config #3: OFDM DQPSK R1/2 @ 15 dB, fixed 4-CW frames."""
    from ria_tpu.phy.pipeline import make_ofdm_rx_pipeline
    from ria_tpu.wave.ofdm import OFDMConfig

    cfg = OFDMConfig(modulation="DQPSK", use_pilots=False)
    rate = "R1_2"
    ci = cfg.bits_per_ofdm_symbol()
    audio = _ofdm_audio(rng, cfg, rate, ci, 64, 8000, 4000, 15.0)
    return Case(make_ofdm_rx_pipeline(cfg, rate, audio.shape[1], ci), audio,
                cfg, rate, ci)


def coherent_case(rng) -> Case:
    """North-star config #4: coherent QAM64 R3/4 @ 25 dB (OFDM-COX
    pilot-assisted MMSE chain — the reference's max-throughput row)."""
    from ria_tpu.phy.frame_v2 import WaveformMode
    from ria_tpu.phy.pipeline import make_ofdm_rx_pipeline
    from ria_tpu.wave.api import create_waveform

    wf = create_waveform(WaveformMode.OFDM_COX, "QAM64", "R3_4")
    rate = "R3_4"
    ci = wf._ci_bits
    audio = _ofdm_audio(rng, wf.cfg, rate, ci, 64, 6000, 3000, 25.0)
    return Case(make_ofdm_rx_pipeline(wf.cfg, rate, audio.shape[1], ci),
                audio, wf.cfg, rate, ci)


CHAINS = {
    "mc_dpsk": ("MC-DPSK DBPSK R1_4 @ 10 dB", mc_dpsk_case),
    "ofdm": ("OFDM DQPSK R1_2 @ 15 dB (config #3)", ofdm_case),
    "coherent": ("OFDM-COX QAM64 R3_4 @ 25 dB (config #4)", coherent_case),
}


def ldpc_batch(rng, B: int = 512):
    """R1/4 LLRs [B, 648] for the serving-path decoder: the first half at a
    comfortable noise level, the second half near the decoding floor, so the
    while_loop runs until the slowest codeword of the call converges."""
    from ria_tpu.fec.ldpc import make_encoder
    from ria_tpu.fec.ldpc_matrix import get_code

    code = get_code("R1_4")
    info = rng.integers(0, 2, (B, code.k)).astype(np.uint8)
    coded = np.asarray(make_encoder("R1_4")(info)).astype(np.float32)
    llr = (1.0 - 2.0 * coded) * 4.0
    noise = rng.normal(0, 1.0, llr.shape).astype(np.float32)
    noise[B // 2 :] = rng.normal(0, 2.6, (B // 2, 648)).astype(np.float32)
    return llr + noise


def _ldpc_metrics(rng):
    """Serving-path decode (fec.ldpc.decode_batch) on the mixed-difficulty
    R1/4 batch of 512, and one 4-codeword control frame, host round-trip
    included."""
    from ria_tpu.fec.ldpc import decode_batch
    from ria_tpu.fec.ldpc_matrix import MIN_SUM_FACTOR

    llr = ldpc_batch(rng)
    B = llr.shape[0]
    out = {}
    for name, rows in (("batch512", llr), ("frame4", np.ascontiguousarray(llr[:4]))):
        fac = np.full(rows.shape[0], MIN_SUM_FACTOR, np.float32)
        variants = [rows + rng.normal(0, 0.05, rows.shape).astype(np.float32)
                    for _ in range(4)]
        ts = time_calls(lambda x: decode_batch(x, fac, "R1_4"), variants, 20)
        med = float(np.median(ts))
        out[f"{name}_ms_median"] = med * 1e3
        out[f"{name}_ms_min"] = min(ts) * 1e3
        if name == "batch512":
            out["batch512_cw_per_s"] = B / med
            r = decode_batch(variants[0], fac, "R1_4")
            out["batch512_decode_ok"] = float(np.asarray(r.success).mean())
    return out


def main() -> None:
    devs = require_gpu()
    import jax

    from ria_tpu.utils.compile_cache import enable_compile_cache

    card = card_info()
    print(f"card: {card}")
    enable_compile_cache()
    rng = np.random.default_rng(0)

    detail = {"device": {"platform": devs[0].platform,
                         "kind": devs[0].device_kind, "count": len(devs)},
              "card": card}
    iters = 30
    for key, (mode, make_case) in CHAINS.items():
        rx, audio = make_case(rng)[:2]
        batch, window = audio.shape
        variants = [jax.device_put(audio + rng.normal(0, 1e-4, audio.shape)
                                   .astype(np.float32)) for _ in range(4)]
        out = jax.block_until_ready(rx(variants[0]))
        ok = np.asarray(out.cw_success)
        det = np.asarray(out.detected)
        if key == "mc_dpsk":
            assert det.all(), f"bench sanity: only {det.sum()}/{batch} synced"
            assert ok.mean() > 0.95, f"bench sanity: cw decode rate {ok.mean():.2f}"
        med = float(np.median(time_calls(rx, variants, iters)))
        detail[key] = {
            "mode": mode,
            "batch": batch,
            "window_samples": window,
            "call_ms_median": med * 1e3,
            "samples_per_s": batch * window / med,
            "vs_realtime": batch * window / med / 48000.0,
            "frames_decoded_per_s": batch / med,
            "detected": int(det.sum()),
            "cw_decode_rate": float(ok.mean()),
        }

    detail["ldpc"] = _ldpc_metrics(rng)
    mc = detail["mc_dpsk"]
    print(json.dumps({
        "metric": "rx_chain_samples_per_sec_per_card",
        "value": mc["samples_per_s"],
        "unit": "samples/s",
        "vs_baseline": mc["vs_realtime"],
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
