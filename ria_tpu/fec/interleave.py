"""Interleavers as static permutation tables (gather ops on the device).

All four reference interleavers, each reduced to its permutation:

- Block Interleaver (rows x cols transpose): perm[i] = col*rows + row
  (reference: src/fec/ldpc_decoder.cpp:459-468).
- ChannelInterleaver: coprime-step permutation output[(i*step) % total] =
  input[i], step = first coprime >= 3*bits_per_symbol
  (reference: src/fec/ldpc_decoder.cpp:550-603).
- FrameInterleaver: fixed 4-CW rotating round-robin,
  interleaved_idx = bit*4 + (cw + bit) % 4, equalizing DQPSK MSB/LSB
  reliability across codewords (reference: src/fec/frame_interleaver.cpp:14-48).
- BurstInterleaver: byte-level row-column spread of N logical frames across
  N physical frames (reference: src/fec/burst_interleaver.hpp:20-34).

Applying a permutation is a static gather — identical host-side (numpy) and
in-graph (jnp); both operate on the last axis and broadcast over leading axes.
"""

from __future__ import annotations

import functools
from math import gcd

import numpy as np

from ria_tpu.fec.ldpc_matrix import BLOCK_BITS


def apply_perm(x, perm, inverse: bool = False):
    """out[perm[i]] = x[i] (scatter form); inverse applies out[i] = x[perm[i]]."""
    perm = np.asarray(perm)
    if inverse:
        return x[..., perm]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return x[..., inv]


@functools.lru_cache(maxsize=None)
def block_perm(rows: int, cols: int) -> np.ndarray:
    n = rows * cols
    i = np.arange(n)
    return (i % cols) * rows + i // cols


@functools.lru_cache(maxsize=None)
def channel_perm(bits_per_symbol: int, total_bits: int = BLOCK_BITS) -> np.ndarray:
    """perm[i] = destination of input bit i."""
    target = bits_per_symbol * 3
    if target >= total_bits:
        target = total_bits // 2
    step = None
    for s in range(target, total_bits):
        if gcd(s, total_bits) == 1:
            step = s
            break
    if step is None:
        for s in range(bits_per_symbol + 1, total_bits):
            if gcd(s, total_bits) == 1:
                step = s
                break
        step = step or bits_per_symbol + 1
    i = np.arange(total_bits)
    return (i * step) % total_bits


FRAME_CODEWORDS = 4
FRAME_BITS = FRAME_CODEWORDS * BLOCK_BITS  # 2592


@functools.lru_cache(maxsize=None)
def frame_perm() -> np.ndarray:
    """perm[original_idx] = interleaved_idx for the fixed 4-CW frame."""
    perm = np.zeros(FRAME_BITS, dtype=np.int64)
    for cw in range(FRAME_CODEWORDS):
        for bit in range(BLOCK_BITS):
            perm[cw * BLOCK_BITS + bit] = bit * FRAME_CODEWORDS + (cw + bit) % FRAME_CODEWORDS
    return perm


def frame_interleave(cw_bits: np.ndarray) -> np.ndarray:
    """[..., 4, 648] coded bits -> [..., 2592] interleaved frame bits."""
    flat = cw_bits.reshape(cw_bits.shape[:-2] + (FRAME_BITS,))
    return apply_perm(flat, frame_perm())


def frame_deinterleave(soft: np.ndarray) -> np.ndarray:
    """[..., 2592] soft bits -> [..., 4, 648] per-codeword soft bits."""
    out = apply_perm(soft, frame_perm(), inverse=True)
    return out.reshape(soft.shape[:-1] + (FRAME_CODEWORDS, BLOCK_BITS))


@functools.lru_cache(maxsize=None)
def stripe_perm(num_cw: int) -> np.ndarray:
    """FrameInterleaver generalized to N codewords (perm[orig] = interleaved):
    interleaved_idx = bit*N + (cw + bit) % N.  A contiguous fade of S coded
    bits on air costs every codeword only ~S/N bits (reference
    frame_interleaver.cpp:14-48 rationale, N=4 there)."""
    perm = np.zeros(num_cw * BLOCK_BITS, dtype=np.int64)
    for cw in range(num_cw):
        for bit in range(BLOCK_BITS):
            perm[cw * BLOCK_BITS + bit] = bit * num_cw + (cw + bit) % num_cw
    return perm


def stripe_interleave(cw_bits: np.ndarray) -> np.ndarray:
    """[..., N, 648] coded bits -> [..., N*648] striped on-air bits."""
    n = cw_bits.shape[-2]
    flat = cw_bits.reshape(cw_bits.shape[:-2] + (n * BLOCK_BITS,))
    return apply_perm(flat, stripe_perm(n))


def stripe_deinterleave(soft: np.ndarray, num_cw: int) -> np.ndarray:
    """[..., N*648] soft bits -> [..., N, 648] per-codeword soft bits."""
    out = apply_perm(soft, stripe_perm(num_cw), inverse=True)
    return out.reshape(soft.shape[:-1] + (num_cw, BLOCK_BITS))


BURST_BYTES_PER_FRAME = 324  # 4 CWs x 81 bytes


@functools.lru_cache(maxsize=None)
def burst_perm(num_frames: int) -> np.ndarray:
    """Byte-level permutation over N*324 bytes: flat = N*b + f -> (frame, byte)."""
    N, B = num_frames, BURST_BYTES_PER_FRAME
    perm = np.zeros(N * B, dtype=np.int64)
    for f in range(N):
        for b in range(B):
            flat = N * b + f
            perm[f * B + b] = flat  # logical (f,b) -> physical position flat
    return perm


def burst_interleave_bytes(frames: np.ndarray) -> np.ndarray:
    """[N, 324] logical coded bytes -> [N, 324] physical frames."""
    N = frames.shape[0]
    flat = frames.reshape(-1)
    return apply_perm(flat, burst_perm(N)).reshape(N, BURST_BYTES_PER_FRAME)


def burst_deinterleave_soft(phys_soft: np.ndarray) -> np.ndarray:
    """[N, 2592] physical soft bits -> [N, 2592] logical order (byte groups of 8)."""
    N = phys_soft.shape[0]
    grouped = phys_soft.reshape(N * BURST_BYTES_PER_FRAME, 8)
    logical = apply_perm(grouped.T, burst_perm(N), inverse=True).T
    return logical.reshape(N, BURST_BYTES_PER_FRAME * 8)
