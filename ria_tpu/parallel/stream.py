"""Time-block sharding of long sample streams with halo exchange.

The reference handles its unbounded "sequence dimension" (the 48 kHz audio
stream) with a single-threaded 20 s ring buffer and a sliding-window search
cursor (streaming_decoder.cpp:386-470).  The accelerator-native equivalent —
required by SURVEY.md §2.12 / the north star — is to shard the stream itself: a long
window [T] is split into contiguous time blocks laid over a 1D ``t`` mesh
axis, and the three stream-crossing computations each exchange exactly the
halo they need over the device interconnect (``jax.lax.ppermute``):

1. **Sync search** — each device correlates its block extended by a
   right-halo of one full preamble, so a chirp straddling a shard boundary is
   found by the shard that owns its first sample; the per-shard best peaks
   are combined with one tiny ``all_gather`` + argmax.
2. **Mix-integrate demod (sequence parallelism)** — once the (replicated)
   frame start is known, each device demodulates exactly the MC symbols whose
   first sample lies in its block (a symbol straddling the boundary reads
   into the halo), producing a [sym_cap, C] slab of carrier integrals; the
   global [S, C] symbol matrix is assembled with one ``psum`` scatter-add.
   The heavy O(S·sps·C) mixer-bank matmul is thus fully distributed; the
   cheap differential/LLR stage runs replicated via the SAME numeric kernel
   the single-chip path uses (wave.mc_dpsk.soft_from_zsym).
3. **FIR filtering** — classic overlap-save: each device prepends a left-halo
   of (taps-1) neighbor samples, convolves, and keeps its own block.

There is no reference counterpart to cite for the parallelism itself (the
reference is single-process C++); the numeric contracts are those of
wave/mc_dpsk.py and sync/chirp.py, which these functions reuse unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ria_tpu.fec.ldpc import make_decoder_vf
from ria_tpu.fec.ldpc_matrix import RECOMMENDED_ITERS

# Min-sum factor ladder for the sharded decode half (phase-0 factor
# diversity of fec/ldpc.decode_with_retries; variant 0 is the fixed-frame
# base factor).
LADDER_FACTORS = (0.9375, 0.75, 0.625, 0.5)
from ria_tpu.sync.chirp import detect_dual_chirp
from ria_tpu.wave.mc_dpsk import MCDPSKConfig, _synth_matrix, soft_from_zsym

LDPC_BITS = 648


def make_stream_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1D time-block mesh.  Device order = time order, so halo exchange is a
    nearest-neighbor ppermute between adjacent devices."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("t",))


# --------------------------------------------------------------------- FIR
def make_sharded_fir(mesh: Mesh, taps: np.ndarray, block_samples: int):
    """Overlap-save FIR over [ch, T] with T sharded on the ``t`` axis.

    Bit-identical to the unsharded causal FIR y[i] = sum_k h[k] x[i-k]
    (zero history before sample 0): each device fetches the last (K-1)
    samples of its left neighbor, convolves the extended block, and keeps
    its own span.  One K-1-sample ppermute per call is the only traffic.
    """
    n = mesh.shape["t"]
    K = int(len(taps))
    h = jnp.asarray(np.asarray(taps, np.float32))
    perm = [(k, k + 1) for k in range(n - 1)]  # send right; dev 0 gets zeros

    def fir(x: jnp.ndarray) -> jnp.ndarray:  # local [ch, block]
        tail = x[:, block_samples - (K - 1):]
        left = jax.lax.ppermute(tail, "t", perm)
        ext = jnp.concatenate([left, x], axis=-1)
        nfft = 1 << (ext.shape[-1] + K - 2).bit_length()
        y = jnp.fft.irfft(jnp.fft.rfft(ext, nfft) * jnp.fft.rfft(h, nfft), nfft)
        return y[:, K - 1 : K - 1 + block_samples].astype(x.dtype)

    sharded = shard_map(fir, mesh=mesh, in_specs=P(None, "t"),
                        out_specs=P(None, "t"))
    return jax.jit(sharded,
                   in_shardings=NamedSharding(mesh, P(None, "t")),
                   out_shardings=NamedSharding(mesh, P(None, "t")))


# ------------------------------------------------------------ stream search
def _gather_best(detected, start, corr, cfo, block_samples: int):
    """Combine per-shard detections: all_gather tiny scalars, pick the peak."""
    i = jax.lax.axis_index("t")
    ok = detected & (start >= 0) & (start < block_samples)
    score = jnp.where(ok, corr, -1.0)
    allc = jax.lax.all_gather(score, "t")                       # [n]
    alls = jax.lax.all_gather(start + i * block_samples, "t")   # [n]
    allf = jax.lax.all_gather(cfo, "t")
    best = jnp.argmax(allc)
    return allc[best] > 0.0, alls[best], allf[best]


def _gather_topk(detected, start, corr, cfo, block_samples: int, k: int):
    """Top-k per-shard detections, score-ordered (multi-frame windows:
    each shard contributes its best in-block candidate, so a window
    holding up to `n_devices` frames — one per block, the practical case
    for half-duplex traffic spaced at least a frame apart — yields every
    frame; two frames inside ONE block is out of contract and takes the
    stronger, exactly like the reference's per-window sliding search)."""
    i = jax.lax.axis_index("t")
    ok = detected & (start >= 0) & (start < block_samples)
    score = jnp.where(ok, corr, -1.0)
    allc = jax.lax.all_gather(score, "t")                       # [n]
    alls = jax.lax.all_gather(start + i * block_samples, "t")   # [n]
    allf = jax.lax.all_gather(cfo, "t")
    order = jnp.argsort(-allc)[:k]
    return allc[order] > 0.0, alls[order], allf[order]


def make_stream_search(mesh: Mesh, chirp_cfg, block_samples: int,
                       halo: int | None = None):
    """Sharded dual-chirp search over a long stream [n*block_samples].

    Returns jitted fn: audio [T] -> (detected, start, cfo_hz), replicated.
    halo defaults to one full preamble + timing margin so a boundary-
    straddling preamble is wholly visible to the shard owning its start.
    """
    n = mesh.shape["t"]
    if halo is None:
        halo = chirp_cfg.total_samples + 4800
    assert halo <= block_samples, "halo must fit in one block"
    perm = [(k + 1, k) for k in range(n - 1)]  # send left; last dev gets zeros

    def search(local: jnp.ndarray):
        right = jax.lax.ppermute(local[:halo], "t", perm)
        ext = jnp.concatenate([local, right])
        res = detect_dual_chirp(ext, chirp_cfg)
        corr = jnp.maximum(res.up_corr, res.down_corr)
        return _gather_best(res.detected, res.start, corr, res.cfo_hz,
                            block_samples)

    sharded = shard_map(search, mesh=mesh, in_specs=P("t"),
                        out_specs=(P(), P(), P()), check_vma=False)
    return jax.jit(sharded, in_shardings=NamedSharding(mesh, P("t")))


# ---------------------------------------------------------------- stream RX
@functools.lru_cache(maxsize=None)
def _stream_geometry(cfg: MCDPSKConfig, num_codewords: int, block_samples: int):
    num_bits = num_codewords * LDPC_BITS
    D = cfg.num_data_symbols(num_bits)
    S_all = cfg.training_symbols + 1 + D * cfg.spreading
    frame_need = cfg.chirp.total_samples + S_all * cfg.samples_per_symbol
    sym_cap = block_samples // cfg.samples_per_symbol + 2
    return num_bits, D, S_all, frame_need, sym_cap


def make_ofdm_stream_rx(mesh: Mesh, ofdm_cfg, rate: str,
                        block_samples: int, ci_bits: int | None = None):
    """Sequence-parallel OFDM RX over a long stream [n*block_samples]
    (the reference's high-SNR workhorse, sharded).

    Pipeline mirrors make_stream_rx's shape for the OFDM chain:
    1. each shard runs the full Schmidl-Cox + LTS search on its block plus
       a right halo covering one whole preamble + the LTS refinement span,
       so a boundary-straddling preamble is found by the shard owning its
       first sample; per-shard results combine with a tiny all_gather;
    2. each shard CP-strips + FFTs exactly the OFDM symbols whose first
       sample lies in its block (boundary symbols read into the halo) with
       the continuous global-time downmix, producing a [sym_cap, bins]
       slab; the global [T+S, bins] matrix assembles with one psum;
    3. channel estimate + MMSE equalize + demap + deinterleave + LDPC run
       replicated via the SAME kernels as the single-chip path
       (wave.ofdm.demodulate_from_bins).
    """
    from ria_tpu.fec.interleave import channel_perm, frame_perm
    from ria_tpu.wave.ofdm import (carrier_layout, demodulate_from_bins,
                                   schmidl_cox_search)

    n = mesh.shape["t"]
    sym = ofdm_cfg.symbol_samples
    T = 2
    S = ofdm_cfg.num_symbols_for_bits(4 * LDPC_BITS)
    num_bits = 4 * LDPC_BITS
    total = n * block_samples
    frame_need = (T + S) * sym
    # Search halo: the SC metric window + LTS refinement span around a
    # preamble starting at the block's last sample.
    halo = ofdm_cfg.preamble_samples + 5 * sym + 2048
    assert halo <= block_samples, (
        f"block_samples {block_samples} must cover the search halo {halo}")
    assert frame_need + ofdm_cfg.preamble_samples <= total
    sym_cap = block_samples // sym + 2
    _, data_bins, pilot_bins = carrier_layout(ofdm_cfg)
    bins = np.concatenate([data_bins, pilot_bins]).astype(np.int64)
    nD = len(data_bins)
    perm = [(k + 1, k) for k in range(n - 1)]

    gather_idx = frame_perm()
    ci_gather = channel_perm(ci_bits) if ci_bits else None

    def stage(local: jnp.ndarray):
        i = jax.lax.axis_index("t")
        right = jax.lax.ppermute(local[:halo], "t", perm)
        ext = jnp.concatenate([local, right])          # [block + halo]

        res = schmidl_cox_search(ext, ofdm_cfg)
        # Ownership: the shard whose block contains the PREAMBLE START
        # claims the frame (LTS sits 5 symbols in — guard + 4 STS — and
        # may legitimately fall in the halo).
        pre_start = res.lts_start - 5 * sym
        detected, pre_g, cfo = _gather_best(
            res.detected, pre_start, res.lts_corr, res.cfo_hz,
            block_samples)
        lts_start = pre_g + 5 * sym
        lts_start = jnp.clip(jnp.where(detected, lts_start, 0), 0,
                             total - frame_need)

        # Symbols owned by this shard: global symbol k iff its first sample
        # lts_start + k*sym lies in [i*block, (i+1)*block).
        lo = i * block_samples
        first = jnp.clip(-((lts_start - lo) // sym), 0, T + S)
        nxt = jnp.clip(-((lts_start - lo - block_samples) // sym), 0, T + S)
        k_slots = first + jnp.arange(sym_cap, dtype=jnp.int32)
        offs = lts_start + k_slots * sym - lo
        offs = jnp.clip(offs, 0, block_samples + halo - sym)
        rows = jax.vmap(lambda o: jax.lax.dynamic_slice(ext, (o,), (sym,)))(offs)

        # Continuous downmix with GLOBAL time origin at lts_start, matching
        # demodulate_presynced's ramp exactly: t = k*sym + j.
        w = (2.0 * jnp.pi / ofdm_cfg.sample_rate) * (ofdm_cfg.center_freq + cfo)
        j = jnp.arange(sym, dtype=jnp.float32)
        rot_in = jnp.exp(-1j * w * j)
        rot_sym = jnp.exp(-1j * w * (k_slots.astype(jnp.float32) * sym))
        bb = rows.astype(jnp.complex64) * rot_in * rot_sym[:, None]
        core = bb[:, ofdm_cfg.cp_len : ofdm_cfg.cp_len + ofdm_cfg.fft_size]
        freq = jnp.fft.fft(core, axis=-1)
        z = freq[:, jnp.asarray(bins)]                 # [sym_cap, nbins]
        valid = k_slots < nxt
        z = jnp.where(valid[:, None], z, 0.0)

        buf = jnp.zeros((T + S + sym_cap, len(bins)), jnp.complex64)
        buf = jax.lax.dynamic_update_slice(buf, z, (first, 0))
        Y = jax.lax.psum(buf[: T + S], "t")

        # ---- decode half, DISTRIBUTED over the same t axis.  The
        # equalize/demap stage is tiny and stays replicated; the LDPC BP —
        # the decode half's FLOPs — shards as (codeword, min-sum-factor
        # variant) pairs round-robin across the axis: shard i decodes
        # codeword i%4 at factor variant i//4, so the otherwise-idle
        # shards run the retry ladder's factor diversity IN THE SAME
        # DISPATCH (fec/ldpc.py decode_with_retries phase 0).  One
        # all_gather combines; the lowest variant index that passes parity
        # wins per codeword.
        #
        # Measured negative finding (round 4): parity-level ladder
        # variants (factor diversity, clip, scale) rescued 0 codewords
        # across 40-seed sweeps at Moderate 9 dB / AWGN sweeps / synthetic
        # overconfident LLRs — normalized min-sum at 0.9375 dominates, and
        # real failures are deep fades or wrong-codeword convergences that
        # only the frame-CRC-aided list decode and HARQ chase combining
        # (wave/api.py) can fix.  The variant slots are kept because they
        # are FREE (idle shards) and match the reference's retry ladder
        # structure, not because they carry measured coding gain.
        vdecoder = make_decoder_vf(rate)
        Yd, Yp = Y[:, :nD], (Y[:, nD:] if len(pilot_bins) else None)
        demod = demodulate_from_bins(Yd, Yp, ofdm_cfg, S, T)
        soft = demod.soft_bits[:num_bits][jnp.asarray(gather_idx)]
        cw_soft = soft.reshape(4, LDPC_BITS)
        if ci_gather is not None:
            cw_soft = cw_soft[:, jnp.asarray(ci_gather)]
        factors = jnp.asarray(LADDER_FACTORS, jnp.float32)
        cw_i = i % 4
        var_i = jnp.minimum(i // 4, len(LADDER_FACTORS) - 1)
        row = jax.lax.dynamic_slice(cw_soft, (cw_i, 0), (1, LDPC_BITS))
        dec = vdecoder(row, factors[var_i][None])
        ok_all = jax.lax.all_gather(dec.success[0], "t")      # [n]
        info_all = jax.lax.all_gather(dec.info_bits[0], "t")  # [n, k]
        return detected, lts_start, cfo, ok_all, info_all, demod.snr_db

    sharded = shard_map(stage, mesh=mesh, in_specs=P("t"),
                        out_specs=(P(), P(), P(), P(), P(), P()),
                        check_vma=False)

    n_var = max(1, min(n // 4, len(LADDER_FACTORS)))

    def rx(audio: jnp.ndarray):
        detected, lts_start, cfo, ok_all, info_all, snr_db = sharded(audio)
        # shard index = var*4 + cw for var < n_var; later shards repeat the
        # last variant (harmless duplicates).  Prefer the lowest variant.
        oks = ok_all[: 4 * n_var].reshape(n_var, 4)
        infos = info_all[: 4 * n_var].reshape(n_var, 4, -1)
        pref = jnp.argmax(oks, axis=0)                 # first passing variant
        cw_success = jnp.any(oks, axis=0) & detected
        info_bits = jnp.take_along_axis(
            infos, pref[None, :, None], axis=0)[0]
        return {
            "detected": detected,
            "lts_start": lts_start,
            "cfo_hz": cfo,
            "cw_success": cw_success,
            "info_bits": info_bits,
            "snr_db": snr_db,
        }

    return jax.jit(rx, in_shardings=NamedSharding(mesh, P("t")))


def make_stream_rx(mesh: Mesh, cfg: MCDPSKConfig, rate: str,
                   num_codewords: int, block_samples: int, top_k: int = 1):
    """Full sharded stream RX: audio [n*block] -> dict of replicated results.

    Pipeline per the module docstring: halo'd chirp search, sequence-parallel
    mix-integrate, psum symbol assembly, replicated differential/LLR + LDPC.
    The frame may land anywhere in the
    stream, including straddling any number of shard boundaries.

    top_k > 1 decodes up to that many frames per window (one candidate per
    shard block, see _gather_topk); results then carry a leading [top_k]
    axis, score-ordered.  top_k == 1 keeps scalar results.
    """
    n = mesh.shape["t"]
    sps = cfg.samples_per_symbol
    C = cfg.num_carriers
    num_bits, D, S_all, frame_need, sym_cap = _stream_geometry(
        cfg, num_codewords, block_samples)
    total = n * block_samples
    halo = max(cfg.chirp.total_samples + 4800, sps)
    assert halo <= block_samples, (
        f"block_samples {block_samples} must cover one preamble halo {halo}")
    assert frame_need <= total, "stream shorter than one frame"
    # Per-row-factor decoder: every codeword is decoded at BOTH ladder
    # factors (0.75 base + 0.9375) in one dispatch, giving the sharded
    # path the single-chip retry ladder's phase-0 factor diversity
    # (fec/ldpc.py decode_with_retries) — low-SNR rescue the old
    # single-factor decode lacked.
    vdecoder = make_decoder_vf(rate, RECOMMENDED_ITERS[rate])
    MC_FACTORS = (0.75, 0.9375)
    Mmix = np.conj(_synth_matrix(cfg)) / sps  # [sps, C] numpy constant
    perm = [(k + 1, k) for k in range(n - 1)]

    def stage(local: jnp.ndarray):
        i = jax.lax.axis_index("t")
        right = jax.lax.ppermute(local[:halo], "t", perm)
        ext = jnp.concatenate([local, right])          # [block + halo]

        res = detect_dual_chirp(ext, cfg.chirp)
        corr = jnp.maximum(res.up_corr, res.down_corr)
        dets, g_starts, cfos = _gather_topk(res.detected, res.start, corr,
                                            res.cfo_hz, block_samples, top_k)
        g_starts = jnp.clip(jnp.where(dets, g_starts, 0), 0,
                            total - frame_need)

        lo = i * block_samples

        def assemble(g_start, cfo):
            data_start = g_start + cfg.chirp.total_samples
            # Symbols owned by this shard: global symbol k iff its first
            # sample data_start + k*sps lies in [i*block, (i+1)*block).
            first = jnp.clip(-((data_start - lo) // sps), 0, S_all)
            nxt = jnp.clip(-((data_start - lo - block_samples) // sps), 0, S_all)
            k_slots = first + jnp.arange(sym_cap, dtype=jnp.int32)
            offs = data_start + k_slots * sps - lo      # local sample offsets
            offs = jnp.clip(offs, 0, block_samples + halo - sps)
            rows = jax.vmap(
                lambda o: jax.lax.dynamic_slice(ext, (o,), (sps,)))(offs)

            # CFO rotation with phase origin at the frame start (k*sps + j),
            # matching wave.mc_dpsk.demodulate's factored ramp exactly.
            w = (2.0 * jnp.pi / cfg.sample_rate) * cfo
            rot_in = jnp.exp(-1j * w * jnp.arange(sps, dtype=jnp.float32))
            rot_sym = jnp.exp(-1j * w * (k_slots.astype(jnp.float32) * sps))
            z = (rows.astype(jnp.complex64) * rot_in) @ jnp.asarray(Mmix)
            z = z * rot_sym[:, None]                    # [sym_cap, C]
            valid = k_slots < nxt
            z = jnp.where(valid[:, None], z, 0.0)

            # Contiguous per-shard slab, one dynamic_update_slice.
            buf = jnp.zeros((S_all + sym_cap, C), jnp.complex64)
            buf = jax.lax.dynamic_update_slice(buf, z, (first, 0))
            return buf[:S_all]

        zsyms = jax.vmap(assemble)(g_starts, cfos)      # [top_k, S_all, C]
        zsyms = jax.lax.psum(zsyms, "t")
        return dets, g_starts, cfos, zsyms

    sharded = shard_map(stage, mesh=mesh, in_specs=P("t"),
                        out_specs=(P(), P(), P(), P()), check_vma=False)

    def rx(audio: jnp.ndarray):
        dets, starts, cfos, zsyms = sharded(audio)
        res = jax.vmap(lambda zz: soft_from_zsym(zz, cfg, D))(zsyms)
        soft = res.soft_bits[..., :num_bits].reshape(top_k * num_codewords,
                                                     LDPC_BITS)
        rows = top_k * num_codewords
        batch = jnp.concatenate([soft] * len(MC_FACTORS))
        facs = jnp.repeat(jnp.asarray(MC_FACTORS, jnp.float32), rows)
        dec = vdecoder(batch, facs)
        ok_v = dec.success.reshape(len(MC_FACTORS), rows)
        info_v = dec.info_bits.reshape(len(MC_FACTORS), rows, -1)
        pref = jnp.argmax(ok_v, axis=0)                # first passing factor
        ok = (jnp.any(ok_v, axis=0).reshape(top_k, num_codewords)
              & dets[:, None])
        info = jnp.take_along_axis(info_v, pref[None, :, None], axis=0)[0]
        info = info.reshape(top_k, num_codewords, -1)
        sb = soft.reshape(top_k, num_codewords, LDPC_BITS)
        out = {
            "detected": dets,
            "start": starts,
            "cfo_hz": cfos,
            "cw_success": ok,
            "info_bits": info,
            "soft_bits": sb,
            "snr_db": res.snr_estimate_db,
        }
        if top_k == 1:
            out = {k: v[0] for k, v in out.items()}
        return out

    return jax.jit(rx, in_shardings=NamedSharding(mesh, P("t")))
