"""Batched LDPC encode / normalized min-sum decode as jitted array programs.

Array-program redesign of the reference's flooding belief-propagation
decoder (reference: src/fec/ldpc_decoder.cpp:154-260): instead of per-edge C++
loops, messages live in a dense ``[batch, checks, max_degree]`` tensor and the
gather/scatter between variable and check nodes is expressed as matmuls with
a static one-hot edge matrix, so the whole iteration runs on the matrix units
and vectorizes over arbitrarily many codewords at once.

Numeric contract matched to the reference:
- normalized min-sum with factor 0.75, message clamp +/-50,
- per-iteration hard-decision parity check with early exit (here: per-codeword
  freeze + global early exit once every codeword in the batch converged),
- LLR sign convention: positive LLR => bit 0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ria_tpu.fec.ldpc_matrix import (
    BLOCK_BITS,
    CODE_PARAMS,
    LLR_CLAMP,
    MIN_SUM_FACTOR,
    RECOMMENDED_ITERS,
    get_code,
)
from ria_tpu.utils.bits import bits_to_bytes, bytes_to_bits


class DecodeResult(NamedTuple):
    info_bits: jnp.ndarray  # [B, k] uint8
    success: jnp.ndarray    # [B] bool
    iterations: jnp.ndarray  # [B] int32
    llr_total: jnp.ndarray  # [B, n] float32 (posterior LLRs, for chase/HARQ)


@functools.lru_cache(maxsize=None)
def make_decoder_vf(rate: str, max_iters: int | None = None,
                    precision: str = "f32"):
    """Build a jitted batched decoder with PER-ROW normalization factors:
    (llrs [B, 648], factors [B]) -> DecodeResult.

    The min-sum factor is a runtime argument, not a compile-time constant,
    so the whole retry ladder's factor diversity (frame_v2.cpp
    decodeFixedFrame phases) shares ONE compiled program and one device
    call — the serving-path requirement (a failed frame costs <= 2 decode
    dispatches, not one per factor).

    precision: "bf16" runs the gather/scatter matmuls with bfloat16 inputs
    and fp32 accumulation (min-sum BP is robust to
    message quantization — hardware decoders use 6-8 bit messages), "f32"
    keeps everything float32.
    """
    code = get_code(rate)
    if max_iters is None:
        max_iters = RECOMMENDED_ITERS[rate]
    m, n, k, D = code.m, code.n, code.k, code.max_degree
    mm_dtype = jnp.bfloat16 if precision == "bf16" else jnp.float32

    # numpy closures lower to MLIR constants without a device readback.
    gather = code.gather.astype(mm_dtype)      # [m*D, n]
    gather_f32 = code.gather.astype(np.float32)  # bf16 parity check (below)
    mask = code.row_mask                       # [m, D]

    def _check_update(v2c, factors):
        """Per-check two-min + sign-product, excluding self (min-sum)."""
        sgn = jnp.where(v2c < 0, -1.0, 1.0)
        sgn = jnp.where(mask, sgn, 1.0)
        sign_prod = jnp.prod(sgn, axis=-1, keepdims=True)
        absv = jnp.where(mask, jnp.abs(v2c), jnp.inf)
        amin = jnp.argmin(absv, axis=-1)
        is_min = jax.nn.one_hot(amin, D, dtype=jnp.bool_)
        min1 = jnp.min(absv, axis=-1, keepdims=True)
        min2 = jnp.min(jnp.where(is_min, jnp.inf, absv), axis=-1, keepdims=True)
        excl_min = jnp.where(is_min, min2, min1)
        # sign excluding edge e == sign_prod * sgn_e (sgn in {-1, +1})
        c2v = sign_prod * sgn * excl_min * factors[:, None, None]
        return jnp.where(mask, c2v, 0.0)

    def _mm(a, b):
        return jnp.dot(a.astype(mm_dtype), b, preferred_element_type=jnp.float32)

    @jax.named_scope("ldpc_bp")  # profiler traces find the decoder by it
    def decode(llrs: jnp.ndarray, factors: jnp.ndarray) -> DecodeResult:
        B = llrs.shape[0]
        llr_in = llrs.astype(jnp.float32)
        factors = factors.astype(jnp.float32)
        v2c0 = _mm(llr_in, gather.T).reshape(B, m, D)

        def cond(carry):
            _, _, done, _, it = carry
            return (it < max_iters) & ~jnp.all(done)

        def body(carry):
            v2c, llr_total, done, iters, it = carry
            c2v = _check_update(v2c, factors)
            llr_total_new = llr_in + _mm(c2v.reshape(B, m * D), gather)
            # One gather serves both the v2c update and the parity check:
            # edge[t, i, d] is the posterior LLR at check i's d-th variable,
            # so its sign IS the gathered hard bit (the old separate
            # hard-bit gather was a third redundant [B,n]x[n,mD] matmul
            # per iteration).
            edge = _mm(llr_total_new, gather.T).reshape(B, m, D)
            v2c_new = jnp.clip(edge - c2v, -LLR_CLAMP, LLR_CLAMP)
            if precision == "bf16":
                # An LLR that rounds to ±0 in bf16 can flip sign vs the f32
                # llr_total the caller's hard bits come from, declaring a
                # failing codeword converged.  Gather the f32 hard bits
                # directly so `done` always reflects the returned bits.
                hard = (llr_total_new < 0).astype(jnp.float32)
                ebits = jnp.dot(hard, gather_f32.T,
                                preferred_element_type=jnp.float32)
                edge_bits = jnp.where(mask, ebits.reshape(B, m, D), 0.0)
            else:
                edge_bits = jnp.where(mask, (edge < 0).astype(jnp.float32), 0.0)
            syndrome = jnp.sum(edge_bits, axis=-1) % 2.0
            ok = jnp.all(syndrome == 0.0, axis=-1)
            upd = ~done
            llr_total = jnp.where(upd[:, None], llr_total_new, llr_total)
            v2c = jnp.where(upd[:, None, None], v2c_new, v2c)
            iters = iters + upd.astype(jnp.int32)
            done = done | ok
            return (v2c, llr_total, done, iters, it + 1)

        init = (
            v2c0,
            llr_in,
            jnp.zeros(B, dtype=bool),
            jnp.zeros(B, dtype=jnp.int32),
            jnp.asarray(0, dtype=jnp.int32),
        )
        _, llr_total, done, iters, _ = jax.lax.while_loop(cond, body, init)
        info_bits = (llr_total[:, :k] < 0).astype(jnp.uint8)
        return DecodeResult(info_bits, done, iters, llr_total)

    return jax.jit(decode)


@functools.lru_cache(maxsize=None)
def make_decoder(rate: str, max_iters: int | None = None,
                 min_sum_factor: float = MIN_SUM_FACTOR,
                 precision: str = "f32"):
    """Jitted batched decoder: llrs [B, 648] -> DecodeResult.

    min_sum_factor: normalization factor (reference default 0.75; the OFDM
    fixed-frame path uses 0.9375 with a factor-diversity retry ladder,
    frame_v2.cpp decodeFixedFrame).  Thin wrapper over make_decoder_vf —
    every factor shares the same compiled executable.
    """
    vf = make_decoder_vf(rate, max_iters, precision)

    def decode(llrs: jnp.ndarray) -> DecodeResult:
        B = llrs.shape[0]
        return vf(llrs, jnp.full((B,), min_sum_factor, jnp.float32))

    return decode


def decode_batch(llrs: np.ndarray, factors: np.ndarray, rate: str,
                 max_iters: int | None = None) -> DecodeResult:
    """Serving-path decode dispatch with per-row min-sum factors: session
    workloads (4-CW frames, control codewords, the retry ladder) all go
    through the XLA while_loop decoder at their own batch size."""
    llrs = np.ascontiguousarray(np.asarray(llrs, np.float32))
    factors = np.asarray(factors, np.float32)
    return make_decoder_vf(rate, max_iters)(jnp.asarray(llrs),
                                            jnp.asarray(factors))


@functools.lru_cache(maxsize=None)
def make_encoder(rate: str):
    """Jitted batched systematic encoder: info_bits [B, k] -> codeword [B, 648]."""
    code = get_code(rate)
    h_data = code.h_data

    def encode(info_bits: jnp.ndarray) -> jnp.ndarray:
        info_f = info_bits.astype(jnp.float32)
        parity = (info_f @ h_data.T) % 2.0
        return jnp.concatenate([info_f, parity], axis=-1).astype(jnp.uint8)

    return jax.jit(encode)


def decode_chunked(llrs, rate: str, chunk: int = 512, max_iters: int | None = None,
                   min_sum_factor: float = MIN_SUM_FACTOR) -> DecodeResult:
    """Decode a large batch in fixed-size chunks.

    The while_loop early-exits only when EVERY codeword in a call converges,
    so one straggler stalls the whole batch; chunking bounds that coupling.
    """
    import numpy as _np

    llrs = _np.asarray(llrs, _np.float32)
    B = llrs.shape[0]
    if B <= chunk:
        return make_decoder(rate, max_iters, min_sum_factor)(llrs)
    dec = make_decoder(rate, max_iters, min_sum_factor)
    pad = (-B) % chunk
    padded = _np.concatenate([llrs, _np.zeros((pad, llrs.shape[1]), _np.float32)])
    outs = [dec(padded[i : i + chunk]) for i in range(0, len(padded), chunk)]
    import jax.numpy as _jnp

    return DecodeResult(
        _jnp.concatenate([o.info_bits for o in outs])[:B],
        _jnp.concatenate([o.success for o in outs])[:B],
        _jnp.concatenate([o.iterations for o in outs])[:B],
        _jnp.concatenate([o.llr_total for o in outs])[:B],
    )


def decode_with_retries(llrs: np.ndarray, rate: str, max_iters: int | None = None,
                        base_factor: float = 0.9375) -> DecodeResult:
    """Decode with the fixed-frame retry ladder in EXACTLY <= 2 device calls.

    The reference retries failed codewords sequentially with min-sum factor
    diversity and Gaussian LLR perturbation (frame_v2.cpp decodeFixedFrame
    phases 0-4).  Here the per-row-factor decoder evaluates the ENTIRE
    ladder — clean factor diversity first, then every perturbed/clipped/
    scaled variant at every retry factor — for every still-failed codeword
    as ONE batched dispatch; row order encodes the reference's retry
    priority, and the first successful row per codeword wins.
    """
    llrs = np.asarray(llrs, np.float32)
    B = llrs.shape[0]
    result = decode_batch(llrs, np.full(B, base_factor, np.float32),
                          rate, max_iters)
    success = np.array(result.success)
    if success.all():
        return result

    info = np.asarray(result.info_bits).copy()
    llr_total = np.asarray(result.llr_total).copy()
    iters = np.asarray(result.iterations).copy()
    failed = ~success
    fidx = np.where(failed)[0]
    base = llrs[failed]
    F = base.shape[0]

    rng = np.random.default_rng(0x5EED)
    rows: list[np.ndarray] = []
    facs: list[float] = []
    # Phase 0: factor diversity on unmodified LLRs (highest priority).
    for factor in (0.875, 0.75, 0.625, 0.5):
        rows.append(base)
        facs.append(factor)
    # Phases 1-4 condensed: perturbation ladder x factor diversity.
    variants = ([("raw", s) for s in (0.3, 0.7, 1.0, 1.5, 2.5)]
                + [("clip10", s) for s in (0.3, 1.5, 4.0)]
                + [("scale", s) for s in (0.5, 3.0)])
    for factor in (0.75, 0.625, 0.875):
        for kind, sigma in variants:
            v = base.copy()
            if kind == "clip10":
                v = np.clip(v, -10, 10)
            elif kind == "scale":
                v = v * 0.5
            v = v + rng.normal(0, sigma, v.shape).astype(np.float32)
            rows.append(v)
            facs.append(factor)

    V = len(rows)
    stacked = np.concatenate(rows, axis=0)                       # [V*F, n]
    factors = np.repeat(np.asarray(facs, np.float32), F)
    r = decode_batch(stacked, factors, rate, max_iters)
    s = np.asarray(r.success).reshape(V, F)
    ib = np.asarray(r.info_bits).reshape(V, F, -1)
    lt = np.asarray(r.llr_total).reshape(V, F, -1)
    it = np.asarray(r.iterations).reshape(V, F)
    any_ok = s.any(axis=0)
    first = np.argmax(s, axis=0)                                 # priority order
    for j in range(F):
        if any_ok[j]:
            gi = fidx[j]
            success[gi] = True
            info[gi] = ib[first[j], j]
            llr_total[gi] = lt[first[j], j]
            iters[gi] = it[first[j], j]

    return DecodeResult(jnp.asarray(info), jnp.asarray(success),
                        jnp.asarray(iters), jnp.asarray(llr_total))


def candidate_plan(num_failed: int) -> list[tuple[str, float]]:
    """(variant kind, min-sum factor) rows per codeword for
    decode_candidates, scaled by how many codewords actually FAILED the
    primary decode (the old flat 31x5 grid built a
    155x host matrix per call regardless).  Factor diversity concentrates
    on the unmodified LLRs; perturbation probes carry one or two factors
    each — the noise probes already diversify the trajectory."""
    ladder = (0.9375, 0.875, 0.75, 0.625, 0.5)
    plan = [("base", f) for f in ladder]
    plan += [("clip", 0.9375), ("half", 0.9375)]
    for k in (16, 32, 64):
        plan += [(f"erase{k}", 0.9375), (f"erase{k}", 0.75)]
    n_noise = 4 * max(1, min(num_failed, 4))
    sigmas = (0.3, 0.7, 1.2, 2.0)
    for j in range(n_noise):
        plan.append((f"noise{j}:{sigmas[j % 4]}", 0.9375))
    return plan


def decode_candidates(llrs: np.ndarray, rate: str, max_iters: int | None = None,
                      max_per_cw: int = 4, num_failed: int = 4):
    """CRC-aided list decoding support: distinct candidate codewords per CW.

    At 648 bits this code (the reference's PEG-like construction) has
    low-weight codeword pairs: after a fade, BP can converge to a
    parity-valid neighbour whose correlation with the received LLRs is as
    good as the true codeword's — an undetectable-by-metric ML ambiguity
    (observed: wrong m/sum|llr| = 0.998 vs truth 0.997).  The frame CRC can
    arbitrate, but needs the alternatives: this decodes a batch of
    perturbed/scaled LLR variants per codeword (one batched device call
    with per-row min-sum factors) and returns, for each codeword, up to
    max_per_cw DISTINCT successful codewords sorted by descending
    correlation metric sum(llr * (1-2*coded)).

    num_failed bounds the probe set (candidate_plan): worst case is
    29 rows/CW = 116 rows for a 4-CW frame (~0.3 MB) vs the old flat
    155x grid's 620.
    """
    llrs = np.asarray(llrs, np.float32)
    B = llrs.shape[0]
    rng = np.random.default_rng(0xC0DE)
    order = np.argsort(np.abs(llrs), axis=1)
    plan = candidate_plan(num_failed)
    rows = np.empty((len(plan), B, llrs.shape[1]), np.float32)
    factors = np.empty(len(plan) * B, np.float32)
    for i, (kind, f) in enumerate(plan):
        if kind == "base":
            v = llrs
        elif kind == "clip":
            v = np.clip(llrs, -10, 10)
        elif kind == "half":
            v = llrs * 0.5
        elif kind.startswith("erase"):
            k = int(kind[5:])
            v = llrs.copy()
            # Zero the k least-reliable bits so BP resolves them from
            # parity alone — deterministic probes of the ambiguity region.
            v[np.repeat(np.arange(B), k), order[:, :k].reshape(-1)] = 0.0
        else:  # noise probe
            sigma = float(kind.split(":")[1])
            v = llrs + rng.normal(0, sigma, llrs.shape).astype(np.float32)
        rows[i] = v
        factors[i * B : (i + 1) * B] = f
    full = rows.reshape(len(plan) * B, llrs.shape[1])
    enc = make_encoder(rate)
    cands: list[dict] = [dict() for _ in range(B)]
    r = decode_batch(full, factors, rate, max_iters)
    s = np.asarray(r.success)
    if s.any():
        info = np.asarray(r.info_bits)[s]
        coded = np.asarray(enc(info)).astype(np.int32)
        for row, inf, cd in zip(np.where(s)[0], info, coded):
            b = row % B
            key = cd.tobytes()
            if key not in cands[b]:
                m = float(np.sum(llrs[b] * (1 - 2 * cd)))
                cands[b][key] = (m, inf)
    return [sorted(c.values(), key=lambda t: -t[0])[:max_per_cw] for c in cands]


class LDPCCodec:
    """Host-facing codec with the reference's multi-block byte semantics.

    Mirrors LDPCEncoder::encode / LDPCDecoder::decodeSoft bit-level block
    handling (reference: src/fec/ldpc_encoder.cpp:193-257,
    src/fec/ldpc_decoder.cpp:286-430): input bits are consumed k at a time
    (zero-padded at the tail), each block emits n coded bits, and decoded
    info bits are concatenated before the single final byte-pack so that
    non-byte-aligned k (e.g. R3/4 k=486) stays bit-exact across blocks.
    """

    def __init__(self, rate: str, max_iters: int | None = None):
        self.rate = rate
        self.code = get_code(rate)
        self.max_iters = max_iters or RECOMMENDED_ITERS[rate]
        self._encode = make_encoder(rate)
        self._decode = make_decoder(rate, self.max_iters)
        self.last_success = False
        self.last_iters = 0

    @property
    def k(self) -> int:
        return self.code.k

    @property
    def n(self) -> int:
        return self.code.n

    def coded_size(self, input_size: int) -> int:
        blocks = -(-(input_size * 8) // self.k)
        return -(-(blocks * self.n) // 8)

    def encode(self, data: bytes) -> bytes:
        bits = bytes_to_bits(data)
        blocks = -(-len(bits) // self.k)
        padded = np.zeros(blocks * self.k, dtype=np.uint8)
        padded[: len(bits)] = bits
        coded = np.asarray(self._encode(jnp.asarray(padded.reshape(blocks, self.k))))
        return bits_to_bytes(coded.reshape(-1))

    def decode_soft(self, llrs: np.ndarray) -> tuple[bool, bytes]:
        """LLRs (positive => bit 0) -> (all_blocks_ok, decoded bytes)."""
        llrs = np.asarray(llrs, dtype=np.float32)
        if llrs.size == 0:
            self.last_success = False
            return False, b""
        blocks = -(-llrs.size // self.n)
        padded = np.zeros(blocks * self.n, dtype=np.float32)
        padded[: llrs.size] = llrs
        result = self._decode(jnp.asarray(padded.reshape(blocks, self.n)))
        info_bits = np.asarray(result.info_bits).reshape(-1)
        ok = bool(np.all(np.asarray(result.success)))
        self.last_success = ok
        self.last_iters = int(np.max(np.asarray(result.iterations)))
        return ok, bits_to_bytes(info_bits)

    def decode_hard(self, coded: bytes) -> tuple[bool, bytes]:
        bits = bytes_to_bits(coded).astype(np.float32)
        return self.decode_soft(np.where(bits > 0.5, -6.0, 6.0))
