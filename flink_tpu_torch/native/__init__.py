"""The native codec layer: typed wrappers over ``csrc/codec.cc`` (the codec
half of ``flink_tpu/native/__init__.py``).

The batch codec's primitives, built with g++ on first use by
``kernels/build.py`` (:func:`~flink_tpu_torch.kernels.build.codec_lib`):

- :func:`lz_compress` / :func:`lz_decompress`: FLZ1 blocks;
- :func:`delta_varint_encode` / :func:`delta_varint_decode`: int64 columns
  as delta + zigzag + varint streams;
- :func:`crc32` (IEEE) and :func:`crc32c` (Castagnoli).

The C source is a copy of the JAX package's, so every function gives the
bytes JAX's native library gives.  There is no fallback: where JAX's wrappers
drop to zlib and pure Python when its library is missing, these raise when
``csrc/codec.cc`` does not build (with the compiler's output), as the
port's other host libraries do.
"""

from __future__ import annotations

import numpy as np

from flink_tpu_torch.kernels import build


def _in(data) -> np.ndarray:
    """A byte buffer as a uint8 array without a copy."""
    return np.frombuffer(data, np.uint8)


def lz_compress(data: bytes) -> bytes:
    """FLZ1-compress ``data`` (JAX's ``lz_compress`` bytes)."""
    lib = build.codec_lib()
    src = _in(data)
    cap = int(lib.ftt_lz_bound(src.size))
    out = np.empty(cap, np.uint8)
    w = lib.ftt_lz_compress(src.ctypes.data, src.size, out.ctypes.data, cap)
    if w < 0:
        raise RuntimeError("lz_compress overflow")
    return out[:w].tobytes()


def lz_decompress(data: bytes, orig_n: int) -> bytes:
    """Inverse of :func:`lz_compress`; ``orig_n`` is the original length.
    Raises ``ValueError`` on a malformed block."""
    lib = build.codec_lib()
    src = _in(data)
    out = np.empty(max(orig_n, 1), np.uint8)
    r = lib.ftt_lz_decompress(src.ctypes.data, src.size, out.ctypes.data,
                              orig_n)
    if r != orig_n:
        raise ValueError("malformed FLZ block")
    return out[:orig_n].tobytes()


def delta_varint_encode(vals) -> bytes:
    """An int64 column as a delta + zigzag + varint stream."""
    lib = build.codec_lib()
    vals = np.ascontiguousarray(vals, np.int64)
    cap = vals.size * 10 + 16
    out = np.empty(cap, np.uint8)
    w = lib.ftt_delta_varint_encode_i64(vals.ctypes.data, vals.size,
                                        out.ctypes.data, cap)
    if w < 0:
        raise RuntimeError("varint encode overflow")
    return out[:w].tobytes()


def delta_varint_decode(data: bytes, n: int) -> np.ndarray:
    """``n`` int64 values from a :func:`delta_varint_encode` stream.
    Raises ``ValueError`` on a malformed stream."""
    lib = build.codec_lib()
    src = _in(data)
    out = np.empty(n, np.int64)
    r = lib.ftt_delta_varint_decode_i64(src.ctypes.data, src.size, n,
                                        out.ctypes.data)
    if r < 0:
        raise ValueError("malformed varint stream")
    return out


def crc32(data: bytes, seed: int = 0) -> int:
    """CRC-32 (IEEE), ``zlib.crc32``'s value."""
    src = _in(data)
    return int(build.codec_lib().ftt_crc32(src.ctypes.data, src.size, seed))


def crc32c(data: bytes, seed: int = 0) -> int:
    """CRC-32C (Castagnoli), the checksum of Kafka's v2 record batches."""
    src = _in(data)
    return int(build.codec_lib().ftt_crc32c(src.ctypes.data, src.size, seed))
