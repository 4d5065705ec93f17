"""Payload encryption and compression.

Wire contracts from the reference:
- AES-256-CBC with PKCS7 padding, output = IV || ciphertext, payload-only
  (control frames stay clear) (src/crypto/aes256.{hpp,cpp});
- deflate (zlib) level 6, only applied when payload >= 32 bytes and the
  compressed form is smaller (src/protocol/compression.{hpp,cpp}).
"""

from __future__ import annotations

import os
import zlib

AES_BLOCK = 16
MIN_COMPRESS_SIZE = 32
COMPRESS_LEVEL = 6


def _pkcs7_pad(data: bytes) -> bytes:
    pad = AES_BLOCK - (len(data) % AES_BLOCK)
    return data + bytes([pad]) * pad


def _pkcs7_unpad(data: bytes) -> bytes:
    if not data or len(data) % AES_BLOCK:
        raise ValueError("bad padded length")
    pad = data[-1]
    if pad < 1 or pad > AES_BLOCK or data[-pad:] != bytes([pad]) * pad:
        raise ValueError("bad padding")
    return data[:-pad]


def _cbc(key: bytes, iv: bytes):
    # Imported here so that sessions without encryption need no
    # `cryptography` package.
    try:
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
    except ImportError as e:
        raise ImportError(
            "payload encryption (AES256) needs the 'cryptography' package") from e
    return Cipher(algorithms.AES(key), modes.CBC(iv))


class AES256:
    """AES-256-CBC, wire = IV || ciphertext (reference src/crypto/aes256.hpp)."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("AES-256 key must be 32 bytes")
        self.key = key

    @classmethod
    def from_passphrase(cls, passphrase: str) -> "AES256":
        import hashlib

        return cls(hashlib.sha256(passphrase.encode()).digest())

    def encrypt(self, plaintext: bytes, iv: bytes | None = None) -> bytes:
        iv = iv or os.urandom(AES_BLOCK)
        enc = _cbc(self.key, iv).encryptor()
        ct = enc.update(_pkcs7_pad(plaintext)) + enc.finalize()
        return iv + ct

    def decrypt(self, wire: bytes) -> bytes:
        if len(wire) < 2 * AES_BLOCK:
            raise ValueError("ciphertext too short")
        iv, ct = wire[:AES_BLOCK], wire[AES_BLOCK:]
        dec = _cbc(self.key, iv).decryptor()
        return _pkcs7_unpad(dec.update(ct) + dec.finalize())


def compress(data: bytes) -> tuple[bytes, bool]:
    """Deflate if it helps; returns (payload, was_compressed)."""
    if len(data) < MIN_COMPRESS_SIZE:
        return data, False
    packed = zlib.compress(data, COMPRESS_LEVEL)
    if len(packed) < len(data):
        return packed, True
    return data, False


def decompress(data: bytes) -> bytes:
    return zlib.decompress(data)
