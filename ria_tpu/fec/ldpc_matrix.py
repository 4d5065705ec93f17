"""Deterministic LDPC parity-check matrix construction (bit-compatible).

Reproduces the reference's pseudo-random PEG-like H-matrix construction
exactly (reference: src/fec/ldpc_encoder.cpp:70-129 and
src/fec/ldpc_decoder.cpp:66-130): ``H = [H_data | I]`` with H_data built by
seeding std::mt19937 with ``0x12345678 + rate_enum`` and hand-rolled
Fisher-Yates shuffles using raw 32-bit draws.  The same seed + algorithm
yields the same matrix, which is a hard bit-compatibility requirement for
interoperating with reference codewords.

Construction is host-side numpy/python and cached per rate; the hot decode
path lives in ``ria_tpu.fec.ldpc`` as jitted array code.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ria_tpu.utils.mt19937 import MT19937

BLOCK_BITS = 648  # codeword length n for all rates

# CodeRate wire enum (reference: include/ultra/types.hpp:91-100)
RATE_ENUM = {"R1_4": 0, "R1_3": 1, "R1_2": 2, "R2_3": 3, "R3_4": 4, "R5_6": 5}

# rate -> (info_bits k, parity_bits m); n = k + m = 648 always
# (reference: src/fec/ldpc_encoder.cpp:38-53)
CODE_PARAMS = {
    "R1_4": (162, 486),
    "R1_2": (324, 324),
    "R2_3": (432, 216),
    "R3_4": (486, 162),
    "R5_6": (540, 108),
}

# Recommended BP iteration counts (reference: src/fec/ldpc_codec.hpp:86-95)
RECOMMENDED_ITERS = {"R1_4": 50, "R1_3": 60, "R1_2": 80, "R2_3": 70, "R3_4": 60, "R5_6": 50}

MIN_SUM_FACTOR = 0.75
LLR_CLAMP = 50.0


@dataclass(frozen=True)
class LDPCCode:
    """Static decode/encode structures for one code rate.

    All arrays are numpy constants baked into jitted functions:

    - ``row_idx [m, D]``: variable index per check-node edge (0-padded).
    - ``row_mask [m, D]``: True on real edges.
    - ``h_data [m, k]``: dense 0/1 data part (encoder: parity = h_data @ info mod 2).
    - ``gather [m*D, n]``: one-hot edge->variable matrix; ``x @ gather.T``
      gathers per-edge values, ``msgs @ gather`` scatter-adds onto variables.
      Expressing gather/scatter as matmuls keeps BP on the matrix units.
    """

    rate: str
    k: int
    m: int
    n: int
    max_degree: int
    row_idx: np.ndarray
    row_mask: np.ndarray
    h_data: np.ndarray
    gather: np.ndarray


def _build_rows(rate: str) -> list[list[int]]:
    """H rows (variable indices per check), identical to the reference build.

    Known artifact reproduced deliberately for bit-compatibility: at high
    rates the construction runs out of check capacity (each of m checks
    accepts at most target_check_degree+2 = 6 edges, but k variables want 3
    each), so the trailing info bits get ZERO parity connections — R3/4 has
    161 unprotected columns, R5/6 has 323 (verified against the reference
    algorithm, ldpc_encoder.cpp:94-118).  Those bits pass through BP at
    their channel LLR only; a flip there is invisible to the parity check
    and is caught by the frame CRC16 (and repaired by the CRC-aided
    candidate list / erasure variants in fec/ldpc.py::decode_candidates).
    This bounds the real coding gain of R3/4 and R5/6 — one reason the
    selection tables only reach R3/4 at 20+ dB."""
    k, m = CODE_PARAMS[rate]
    rng = MT19937((0x12345678 + RATE_ENUM[rate]) & 0xFFFFFFFF)

    target_check_degree = 4
    target_var_degree = max(3, (target_check_degree * m) // k)
    target_var_degree = min(target_var_degree, m // 2)
    max_check_degree = target_check_degree + 2

    rows: list[list[int]] = [[] for _ in range(m)]
    check_degrees = [0] * m

    for j in range(k):
        available = [i for i in range(m) if check_degrees[i] < max_check_degree]
        # Fisher-Yates with raw rng() % i draws, matching the reference's
        # cross-compiler-deterministic shuffle exactly.
        for i in range(len(available), 1, -1):
            swap_with = rng() % i
            available[i - 1], available[swap_with] = available[swap_with], available[i - 1]
        connections = min(target_var_degree, len(available))
        for d in range(connections):
            check = available[d]
            rows[check].append(j)
            check_degrees[check] += 1

    for i in range(m):
        if not rows[i]:
            rows[i].append(rng() % k)

    # Identity part: parity bit k+i participates in check i.
    for i in range(m):
        rows[i].append(k + i)
    return rows


@functools.lru_cache(maxsize=None)
def get_code(rate: str) -> LDPCCode:
    k, m = CODE_PARAMS[rate]
    n = k + m
    rows = _build_rows(rate)

    max_degree = max(len(r) for r in rows)
    # Round the edge dimension up to a lane-friendly multiple where cheap.
    D = max_degree
    row_idx = np.zeros((m, D), dtype=np.int32)
    row_mask = np.zeros((m, D), dtype=bool)
    for i, r in enumerate(rows):
        row_idx[i, : len(r)] = r
        row_mask[i, : len(r)] = True

    h_data = np.zeros((m, k), dtype=np.float32)
    for i, r in enumerate(rows):
        for j in r:
            if j < k:
                h_data[i, j] = 1.0

    gather = np.zeros((m * D, n), dtype=np.float32)
    flat_idx = row_idx.reshape(-1)
    flat_mask = row_mask.reshape(-1)
    gather[np.arange(m * D)[flat_mask], flat_idx[flat_mask]] = 1.0

    return LDPCCode(
        rate=rate,
        k=k,
        m=m,
        n=n,
        max_degree=D,
        row_idx=row_idx,
        row_mask=row_mask,
        h_data=h_data,
        gather=gather,
    )


def encode_np(info_bits: np.ndarray, rate: str) -> np.ndarray:
    """Encode k info bits -> n codeword bits (systematic), numpy host path."""
    code = get_code(rate)
    info_bits = np.asarray(info_bits, dtype=np.int64)
    assert info_bits.shape[-1] == code.k, (info_bits.shape, code.k)
    parity = (info_bits @ code.h_data.T.astype(np.int64)) % 2
    return np.concatenate([info_bits, parity], axis=-1).astype(np.uint8)
