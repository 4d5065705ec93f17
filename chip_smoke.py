"""Smoke test of the modem's main path on a GPU, through its user entry points.

    python chip_smoke.py          # phases 0-6 on one card
    python chip_smoke.py --four   # only ria_tpu.parallel on four cards,
                                  # compared with one card

Phases (one card):
  0. device: a GPU or exit non-zero; its kind, count, name and power limit;
  1. compile the three RX chains of bench.py at production size (B=64):
     compile seconds and memory_analysis() of each;
  2. decode each chain: every window detected, >= 0.95 codewords decoded;
  3. reference: the first 8 windows of each chain on the CPU backend at
     "highest" matmul precision, and on the GPU at "highest", against the GPU
     at the precision the code pins; the TX synthesis likewise;
  4. LDPC serving path (fec.ldpc.decode_batch): a 4-CW frame and the R1/4
     batch of 512 against the CPU at "highest", and the GPU time per call;
  5. CLI: ptx then prx in-process, for MC_DPSK and OFDM_COX;
  6. one protocol session (PING -> CONNECT -> DATA -> DISCONNECT) through
     tools/cli_simulator.py at 10 dB AWGN.

Everything runs in this one process.  A failed phase raises and the script
exits non-zero; the last line of stdout is the JSON result, printed only
when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Phase-3 tolerances between two runs of one chain on the same windows.
# Decisions must agree exactly; the estimates may differ by float rounding
# (TF32 vs float32 dots, another summation order on another backend) far
# below what the modem resolves.
START_TOL = 1        # samples
CFO_TOL_HZ = 0.1
SNR_TOL_DB = 0.1
# TX synthesis: the difference must stay this far below the signal power,
# well under the noise floor of any SNR the modem runs at.
TX_ERR_TOL_DB = -50.0
REF_WINDOWS = 8


class PhaseFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    names = ("argument_size_in_bytes", "output_size_in_bytes",
             "alias_size_in_bytes", "temp_size_in_bytes",
             "generated_code_size_in_bytes")
    return " ".join(f"{n.replace('_size_in_bytes', '')}={getattr(m, n)}"
                    for n in names if hasattr(m, n))


# ------------------------------------------------------------- phases 1-2
def compile_and_decode(rng):
    """Phases 1 and 2; returns {chain: (rx, audio)}."""
    import jax

    from bench import CHAINS

    chains = {}
    for key, (mode, make_case) in CHAINS.items():
        rx, audio = make_case(rng)[:2]
        x = jax.device_put(audio)
        t0 = time.perf_counter()
        compiled = rx.lower(x).compile()
        dt = time.perf_counter() - t0
        log(f"[1] compile {key} ({mode}) B={audio.shape[0]} "
            f"window={audio.shape[1]}: {dt:.2f} s; memory {_memory(compiled)}")
        out = jax.block_until_ready(compiled(x))
        det = np.asarray(out.detected)
        ok = np.asarray(out.cw_success)
        log(f"[2] decode {key}: detected {int(det.sum())}/{det.size}, "
            f"cw decode rate {float(ok.mean())!r} ({int(ok.sum())}/{ok.size})")
        check(det.all(), f"{key}: only {det.sum()}/{det.size} windows detected")
        check(ok.mean() >= 0.95, f"{key}: cw decode rate {ok.mean()} < 0.95")
        chains[key] = (rx, audio)
    return chains


# ---------------------------------------------------------------- phase 3
def _run_on(fn, x, device, precision=None):
    import jax

    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with jax.default_device(device), ctx:
        out = jax.block_until_ready(fn(jax.device_put(x, device)))
    return jax.tree.map(np.asarray, out)


def compare_rx(name: str, a, b) -> None:
    """Print every difference between two RX results beside its tolerance;
    raise if one exceeds it."""
    start = "start" if hasattr(a, "start") else "lts_start"
    det_a, det_b = a.detected, b.detected
    both = det_a & det_b
    ok_a, ok_b = a.cw_success, b.cw_success
    dec = ok_a & ok_b
    diffs = {
        "detected_mismatch": (int((det_a != det_b).sum()), 0),
        "cw_success_mismatch": (int((ok_a != ok_b).sum()), 0),
        "info_bits_mismatch": (int((a.info_bits != b.info_bits)[dec].sum()), 0),
        "start_max_diff": (int(np.abs(getattr(a, start).astype(np.int64)
                                      - getattr(b, start))[both].max(initial=0)),
                           START_TOL),
        "cfo_hz_max_diff": (float(np.abs(a.cfo_hz - b.cfo_hz)[both].max(initial=0)),
                            CFO_TOL_HZ),
        "snr_db_max_diff": (float(np.abs(a.snr_db - b.snr_db)[both].max(initial=0)),
                            SNR_TOL_DB),
    }
    log(f"[3] {name}: " + " ".join(f"{k}={v!r} (tol {t})"
                                    for k, (v, t) in diffs.items()))
    for k, (v, t) in diffs.items():
        check(v <= t, f"{name}: {k}={v} exceeds {t}")


def reference_comparison(chains, gpu, cpu) -> None:
    for key, (rx, audio) in chains.items():
        x = audio[:REF_WINDOWS]
        pinned = _run_on(rx, x, gpu)
        compare_rx(f"{key} gpu-highest vs gpu-pinned", _run_on(rx, x, gpu, "highest"), pinned)
        compare_rx(f"{key} cpu-highest vs gpu-pinned", _run_on(rx, x, cpu, "highest"), pinned)

    # TX synthesis (phy.pipeline.make_tx_pipeline), the input path above.
    from ria_tpu.fec.ldpc import make_encoder
    from ria_tpu.phy.pipeline import make_tx_pipeline
    from ria_tpu.wave.mc_dpsk import MCDPSKConfig

    cfg = MCDPSKConfig(num_carriers=10, bits_per_symbol=1)
    rng = np.random.default_rng(1)
    info = rng.integers(0, 2, (REF_WINDOWS * 4, 162)).astype(np.uint8)
    coded = np.asarray(make_encoder("R1_4")(info)).reshape(REF_WINDOWS, 4 * 648)
    tx = make_tx_pipeline(cfg, 4)
    ref = _run_on(tx, coded, cpu, "highest")
    for label, out in (("gpu-pinned", _run_on(tx, coded, gpu)),
                       ("gpu-highest", _run_on(tx, coded, gpu, "highest"))):
        err_db = 10 * np.log10(np.mean((out - ref) ** 2) / np.mean(ref ** 2)
                               + 1e-30)
        log(f"[3] tx cpu-highest vs {label}: error {err_db:.1f} dB "
            f"re signal (tol {TX_ERR_TOL_DB} dB)")
        check(err_db <= TX_ERR_TOL_DB, f"tx {label}: error {err_db:.1f} dB")


# ---------------------------------------------------------------- phase 4
def ldpc_serving(rng, cpu) -> None:
    import jax

    from bench import ldpc_batch, time_calls
    from ria_tpu.fec.ldpc import decode_batch
    from ria_tpu.fec.ldpc_matrix import MIN_SUM_FACTOR

    llr = ldpc_batch(rng)
    half = llr.shape[0] // 2
    for name, rows in (("frame4", np.ascontiguousarray(llr[:4])),
                       ("batch512", llr)):
        fac = np.full(rows.shape[0], MIN_SUM_FACTOR, np.float32)
        g = jax.tree.map(np.asarray, decode_batch(rows, fac, "R1_4"))
        with jax.default_device(cpu), jax.default_matmul_precision("highest"):
            c = jax.tree.map(np.asarray, decode_batch(rows, fac, "R1_4"))
        clean = slice(0, min(half, rows.shape[0]))
        check((g.success[clean] == c.success[clean]).all(),
              f"{name}: success differs from the CPU on the clean rows")
        check(g.success[clean].all(), f"{name}: a clean row failed to decode")
        check((g.info_bits[clean] == c.info_bits[clean]).all(),
              f"{name}: bits differ from the CPU on the clean rows")
        msg = f"[4] {name} vs cpu-highest: clean rows equal"
        if rows.shape[0] > half:
            gs, cs = g.success[half:], c.success[half:]
            both = gs & cs
            bits_bad = int((g.info_bits[half:] != c.info_bits[half:])[both].sum())
            check(bits_bad == 0, f"{name}: near-floor bits differ where both decoded")
            msg += (f"; near-floor rows: gpu ok {int(gs.sum())}, cpu ok "
                    f"{int(cs.sum())}, both {int(both.sum())}, success sets "
                    f"agree on {int((gs == cs).sum())}/{gs.size}, bits equal "
                    f"where both decoded")
        log(msg)
        variants = [rows + rng.normal(0, 0.05, rows.shape).astype(np.float32)
                    for _ in range(4)]
        ts = time_calls(lambda x: decode_batch(x, fac, "R1_4"), variants, 20)
        log(f"[4] {name} decode_batch on the GPU: median {float(np.median(ts)) * 1e3!r} ms, "
            f"min {min(ts) * 1e3!r} ms per call (20 calls after warm-up, "
            f"host transfer included)")


# ---------------------------------------------------------------- phase 5
def cli_loopback() -> None:
    from ria_tpu.cli import main as cli

    with tempfile.TemporaryDirectory() as tmp:
        for wf in ("MC_DPSK", "OFDM_COX"):
            text = f"chip smoke {wf}"
            path = os.path.join(tmp, f"{wf}.f32")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc_tx = cli(["ptx", text, "-s", "W1AW", "-d", "VE3ABC",
                             "-w", wf, "-o", path])
                rc_rx = cli(["prx", path])
            out = buf.getvalue()
            check(rc_tx == 0 and rc_rx == 0, f"cli {wf}: rc {rc_tx}/{rc_rx}")
            check(text in out, f"cli {wf}: payload not decoded:\n{out}")
            line = next(l for l in out.splitlines() if text in l)
            log(f"[5] cli {wf}: {line.strip()}")


# ---------------------------------------------------------------- phase 6
def session() -> None:
    import jax

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from cli_simulator import main as simulate

    compile_s = [0.0]
    events = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def on_duration(event, secs, **_):
        if event in events:
            compile_s[0] += secs

    jax.monitoring.register_event_duration_secs_listener(on_duration)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = simulate(["--snr", "10", "--channel", "awgn", "--seeds", "1",
                           "--seed-base", "3"])
    finally:
        jax.monitoring.unregister_event_duration_listener(on_duration)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    result = [l for l in out.splitlines() if l.startswith("RESULT")]
    log(f"[6] session: {result[-1] if result else 'no RESULT line'}; "
        f"wall {wall:.2f} s, of which tracing+lowering+compiling {compile_s[0]:.2f} s")
    check(rc == 0 and result and "1/1 seeds passed" in result[-1],
          f"session failed:\n{out[-3000:]}")


# ---------------------------------------------------------------- --four
def four_cards() -> None:
    """ria_tpu.parallel on a (2 x 2) batch mesh and a 4-block stream mesh,
    compared with the single-card pipelines on the same inputs."""
    import jax

    from bench import mc_dpsk_case, ofdm_case
    from ria_tpu.fec.ldpc import make_encoder
    from ria_tpu.parallel.mesh import (make_mesh, make_sharded_ofdm_rx,
                                       make_sharded_rx)
    from ria_tpu.parallel.stream import make_stream_mesh, make_stream_rx
    from ria_tpu.phy.pipeline import make_rx_pipeline, make_tx_pipeline

    check(len(jax.devices()) >= 4, f"--four needs 4 devices, "
          f"found {len(jax.devices())}")
    rng = np.random.default_rng(0)
    mesh = make_mesh(4)
    log(f"[4x] batch mesh {dict(mesh.shape)}")

    def same(name, one, four, fields):
        for f in fields:
            a, b = np.asarray(getattr(one, f)), np.asarray(getattr(four, f))
            check(a.shape == b.shape and (a == b).all(),
                  f"{name}: {f} differs between one card and four")
        log(f"[4x] {name}: {', '.join(fields)} equal on {len(np.asarray(one.detected))} "
            f"windows; detected {int(np.asarray(four.detected).sum())}, cw decoded "
            f"{int(np.asarray(four.cw_success).sum())}/{np.asarray(four.cw_success).size}")

    dev0 = jax.devices()[0]
    mc = mc_dpsk_case(rng)
    cfg = mc.cfg
    audio = mc.audio
    one = jax.block_until_ready(mc.rx(jax.device_put(audio, dev0)))
    rx4 = make_sharded_rx(mesh, cfg, mc.rate, 4, audio.shape[1])
    same("mc_dpsk make_sharded_rx", one, jax.block_until_ready(rx4(audio)),
         ("detected", "start", "cw_success", "info_bits"))

    of = ofdm_case(rng)
    audio = of.audio
    one = jax.block_until_ready(of.rx(jax.device_put(audio, dev0)))
    rx4 = make_sharded_ofdm_rx(mesh, of.cfg, of.rate, audio.shape[1], of.ci_bits)
    same("ofdm make_sharded_ofdm_rx", one, jax.block_until_ready(rx4(audio)),
         ("detected", "lts_start", "cw_success", "info_bits"))

    # Stream mesh: one MC-DPSK frame straddling the block 1 -> 2 boundary.
    halo = max(cfg.chirp.total_samples + 4800, cfg.samples_per_symbol)
    block = 10 * halo
    total = 4 * block
    info = rng.integers(0, 2, (4, 162)).astype(np.uint8)
    coded = np.asarray(make_encoder("R1_4")(info)).reshape(1, 4 * 648)
    tx = np.asarray(make_tx_pipeline(cfg, 4)(coded))[0]
    pos = 2 * block - len(tx) // 2
    stream = np.zeros(total, np.float32)
    stream[pos : pos + len(tx)] = tx
    rms = float(np.sqrt(np.mean(tx ** 2)))
    stream += rng.normal(0, rms * 10 ** (-10 / 20), total).astype(np.float32)
    srx = make_stream_rx(make_stream_mesh(4), cfg, "R1_4", 4, block)
    s4 = jax.block_until_ready(srx(stream))
    s1 = make_rx_pipeline(cfg, "R1_4", 4, total)(
        jax.device_put(stream[None], dev0))
    s1 = jax.tree.map(lambda v: np.asarray(v)[0], s1)
    for f in ("detected", "start", "cw_success", "info_bits"):
        check(np.array_equal(np.asarray(s4[f]), getattr(s1, f)),
              f"stream: {f} differs between one card and four "
              f"({np.asarray(s4[f])!r} vs {getattr(s1, f)!r})")
    check(bool(s4["detected"]) and np.asarray(s4["cw_success"]).all(),
          "stream: frame not decoded")
    log(f"[4x] mc_dpsk make_stream_rx: block {block} (halo {halo}), frame at "
        f"{pos} straddles {2 * block}; start {int(s4['start'])}, detected, "
        f"cw_success and info_bits equal to the single-card make_rx_pipeline")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card parallel path")
    args = ap.parse_args(argv)

    # Phase 0: a GPU, or no result at all.
    from bench import card_info, require_gpu

    devs = require_gpu()
    import jax

    from ria_tpu.utils.compile_cache import enable_compile_cache

    log(f"[0] device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    log(f"[0] nvidia-smi name, power.limit: {card_info()}")
    log(f"[0] compile cache: {enable_compile_cache()}")

    if args.four:
        four_cards()
    else:
        gpu, cpu = devs[0], jax.devices("cpu")[0]
        rng = np.random.default_rng(0)
        chains = compile_and_decode(rng)
        reference_comparison(chains, gpu, cpu)
        ldpc_serving(rng, cpu)
        cli_loopback()
        session()

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
