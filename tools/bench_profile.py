"""Stage-level profile of the MC-DPSK RX chain of bench.py: where does the time go?

1. Times each jitted stage separately (sync search, frame slice + demod,
   LDPC decode) and the whole chain, at the bench geometry: one warm-up call
   per input, then calls that each end in block_until_ready.
2. With --trace DIR, records a jax.profiler trace of a few calls of the
   whole chain and prints the share of device time spent in the LDPC
   decoder (the ops under the decoder's "ldpc_bp" named scope), read from
   the trace's per-op device events.  XLA on the GPU replays runs of
   kernels, the decoder's while_loop among them, as command buffers (CUDA
   graphs) that show in the trace as one "command_buffer" event with no
   HLO op name; turn them off for the traced run to attribute every kernel.

Not part of the test suite.  Usage:
  python tools/bench_profile.py
  XLA_FLAGS=--xla_gpu_enable_command_buffer= \
      python tools/bench_profile.py --trace chiprun_out/trace
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import glob
import re

import numpy as np


def scope_ops(hlo_text: str, scope: str) -> set[str]:
    """Names of the HLO instructions whose op_name metadata lies under a
    named scope (trace events name the instruction that ran)."""
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name="([^"]*)"')
    return {m.group(1) for line in hlo_text.splitlines()
            if (m := pat.match(line)) and f"{scope}/" in m.group(2)}


def device_op_times(xplane_path: str, module_prefix: str):
    """{hlo_op: summed device ns} for one jitted module, and the busy ns
    (union of the module's op intervals) — from the device planes of a
    trace, or the host threads that ran the ops where no device plane
    exists (CPU backend)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    planes = [p for p in pd.planes if p.name.startswith("/device:")]
    planes = planes or list(pd.planes)
    per_op: dict[str, float] = {}
    spans = []
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op, mod = stats.get("hlo_op"), stats.get("hlo_module", "")
                # Control-flow ops span the ops they run (CPU backend).
                if (not op or not str(mod).startswith(module_prefix)
                        or op.startswith(("while", "conditional", "call"))):
                    continue
                per_op[op] = per_op.get(op, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, -np.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return per_op, busy


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="directory for a profiler trace of the whole chain")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import mc_dpsk_case, time_calls
    from ria_tpu.fec.ldpc import make_decoder
    from ria_tpu.fec.ldpc_matrix import RECOMMENDED_ITERS
    from ria_tpu.sync.chirp import detect_dual_chirp
    from ria_tpu.utils.compile_cache import enable_compile_cache
    from ria_tpu.wave.mc_dpsk import demodulate

    enable_compile_cache()
    rng = np.random.default_rng(0)
    case = mc_dpsk_case(rng)
    cfg, audio = case.cfg, case.audio
    batch, window = audio.shape
    ncw = 4
    num_bits = ncw * 648
    auds = [jax.device_put(audio + rng.normal(0, 1e-4, audio.shape).astype(np.float32))
            for _ in range(4)]

    sync_fn = jax.jit(lambda a: detect_dual_chirp(a, cfg.chirp))
    sync = sync_fn(auds[0])
    n_sym = cfg.num_data_symbols(num_bits)
    frame_need = (cfg.training_symbols + 1 + n_sym * cfg.spreading) * cfg.samples_per_symbol
    start = jnp.clip(sync.start + cfg.chirp.total_samples, 0, window - frame_need)

    @jax.jit
    def demod_fn(a, s, c):
        frames = jax.vmap(lambda x, i: jax.lax.dynamic_slice(x, (i,), (frame_need,)))(a, s)
        return demodulate(frames, c, cfg, n_sym)

    softs = [demod_fn(a, start, sync.cfo_hz).soft_bits[..., :num_bits]
             .reshape(batch * ncw, 648) for a in auds]
    dec = make_decoder("R1_4", RECOMMENDED_ITERS["R1_4"], 0.75)

    stages = [("sync", sync_fn, auds),
              ("demod", lambda a: demod_fn(a, start, sync.cfo_hz), auds),
              ("ldpc", dec, softs),
              ("full", case.rx, auds)]
    print(f"device: {jax.devices()[0].device_kind}  geometry: batch={batch} "
          f"window={window} ncw={ncw}")
    for name, fn, inputs in stages:
        t = float(np.median(time_calls(fn, inputs, 20)))
        print(f"{name:6s} {t * 1e3:10.3f} ms  {batch * window / t / 1e6:10.1f} Msamp/s")

    if args.trace:
        hlo = case.rx.lower(auds[0]).compile().as_text()
        ldpc_ops = scope_ops(hlo, "ldpc_bp")
        jax.profiler.start_trace(args.trace)
        for a in auds:
            jax.block_until_ready(case.rx(a))
        jax.profiler.stop_trace()
        path = max(glob.glob(_os.path.join(args.trace, "**", "*.xplane.pb"),
                             recursive=True), key=_os.path.getmtime)
        per_op, busy = device_op_times(path, "jit_rx")
        total = sum(per_op.values())
        ldpc = sum(v for k, v in per_op.items() if k in ldpc_ops)
        print(f"trace {path}: {len(auds)} calls, op time {total / 1e6:.3f} ms, "
              f"busy {busy / 1e6:.3f} ms, LDPC (ldpc_bp ops) {ldpc / 1e6:.3f} ms "
              f"= {100 * ldpc / max(total, 1):.1f}% of op time")
        for op, ns in sorted(per_op.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {ns / 1e6:10.3f} ms  {'ldpc ' if op in ldpc_ops else '     '}{op}")


if __name__ == "__main__":
    main()
