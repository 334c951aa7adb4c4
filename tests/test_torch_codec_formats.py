"""Port parity for the batch codec and the formats: ``csrc/codec.cc``
through ``flink_tpu_torch.native`` (FLZ blocks, delta varints, CRC-32 and
CRC-32C), ``native/codec.py`` (the FTB1 batch codec) and
``formats/__init__.py`` (CSV, JSON lines, FTB files and their CRC frames),
held to the JAX package's native library and modules byte for byte.

A batch, a frame or a file that one package writes reads in the other.  The
port has no fallback: a codec library that does not build raises.
"""

import json
import os
import shutil
import zlib

import numpy as np
import pytest

import flink_tpu.formats as jfmt
import flink_tpu.native as jnat
import flink_tpu.native.codec as jcodec
from flink_tpu.core.batch import RecordBatch as JaxBatch
import flink_tpu_torch.formats as pfmt
import flink_tpu_torch.native as pnat
import flink_tpu_torch.native.codec as pcodec
from flink_tpu_torch.core.batch import RecordBatch
from flink_tpu_torch.kernels import build

_RNG = np.random.default_rng(2024)
_RANDOM = _RNG.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
#: inputs the compressor must handle: empty, tiny, incompressible, runs
#: longer than 255 (varint length extensions on both nibbles), low entropy,
#: a block repeated past the 64 KiB window (no match may reach it), text
BLOBS = {
    "empty": b"",
    "one-byte": b"x",
    "three-bytes": b"abc",
    "incompressible": _RANDOM,
    "long-run": b"a" * 10_000,
    "runs-and-literals": b"".join(bytes([i % 251]) * (i % 700 + 1)
                                  + _RANDOM[i:i + 300] for i in range(40)),
    "low-entropy": _RNG.integers(0, 4, 60_000, dtype=np.uint8).tobytes(),
    "repeat-past-window": _RANDOM[:70_000] * 2,
    "text": " ".join(f"word{i % 97}" for i in range(20_000)).encode(),
}
INT64 = np.iinfo(np.int64)
COLUMNS_I64 = {
    "empty": np.zeros(0, np.int64),
    "sorted-ts": np.cumsum(_RNG.integers(0, 50, 50_000)).astype(np.int64),
    "random": _RNG.integers(INT64.min, INT64.max, 20_000, dtype=np.int64),
    "extremes": np.asarray([0, INT64.min, INT64.max, -1, 1, INT64.min,
                            INT64.max, 0], np.int64),
    "constant-gap": np.arange(0, 300_000, 3, dtype=np.int64),
}


@pytest.mark.parametrize("name", BLOBS)
def test_flz_blocks_equal_jax(name):
    data = BLOBS[name]
    block = pnat.lz_compress(data)
    assert block == jnat.lz_compress(data)
    assert pnat.lz_decompress(block, len(data)) == data
    assert jnat.lz_decompress(block, len(data)) == data


def test_flz_malformed_block_raises_as_in_jax():
    block = pnat.lz_compress(BLOBS["text"])
    for bad in (block[:-3], block + b"\x00", b"\xff" * 8):
        with pytest.raises(ValueError, match="malformed"):
            jnat.lz_decompress(bad, len(BLOBS["text"]))
        with pytest.raises(ValueError, match="malformed"):
            pnat.lz_decompress(bad, len(BLOBS["text"]))


@pytest.mark.parametrize("name", COLUMNS_I64)
def test_delta_varint_equals_jax(name):
    vals = COLUMNS_I64[name]
    enc = pnat.delta_varint_encode(vals)
    assert enc == jnat.delta_varint_encode(vals)
    np.testing.assert_array_equal(pnat.delta_varint_decode(enc, vals.size),
                                  vals)
    np.testing.assert_array_equal(jnat.delta_varint_decode(enc, vals.size),
                                  vals)
    if vals.size:
        with pytest.raises(ValueError, match="malformed"):
            pnat.delta_varint_decode(enc[:-1] + b"\x80", vals.size)


@pytest.mark.parametrize("name", BLOBS)
def test_crcs_equal_jax(name):
    data = BLOBS[name]
    for seed in (0, 0xDEADBEEF):
        assert pnat.crc32(data, seed) == jnat.crc32(data, seed) \
            == zlib.crc32(data, seed)
        assert pnat.crc32c(data, seed) == jnat.crc32c(data, seed)


def _columns(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    return {
        "i64": rng.integers(-10**12, 10**12, n).astype(np.int64),
        "i32": rng.integers(-1000, 1000, n).astype(np.int32),
        "f64": rng.standard_normal(n),
        "f32": rng.standard_normal(n).astype(np.float32),
        "bool": rng.random(n) < 0.3,
        "str": np.asarray([f"s{i % 37}" for i in range(n)]),
        "obj": np.asarray([("k", i % 5) if i % 3 else None
                           for i in range(n)], object),
        "mat": rng.standard_normal((n, 3)).astype(np.float32),
        "ones": np.ones(n, np.int64),
    }


def _batches(RB):
    n = 3000
    rng = np.random.default_rng(9)
    ts = np.sort(rng.integers(0, 10**6, n)).astype(np.int64)
    kid = rng.integers(0, 500, n).astype(np.int32)
    kg = rng.integers(0, 128, n).astype(np.int32)
    return {
        "columns": RB(_columns(n)),
        "ts-keys-groups": RB(_columns(n), ts, kid, kg),
        "ts-only": RB({"v": np.arange(n, dtype=np.float64)}, ts),
        "empty": RB({"v": np.zeros(0, np.int64)}),
        "tiny": RB({"v": np.arange(3, dtype=np.int64)}),
    }


def _same_batch(a, b):
    assert list(a.columns) == list(b.columns)
    for name in a.columns:
        x, y = np.asarray(a.column(name)), np.asarray(b.column(name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if x.dtype == object:
            assert x.tolist() == y.tolist(), name
        else:
            assert x.tobytes() == y.tobytes(), name
    for attr in ("timestamps", "key_ids", "key_groups"):
        x, y = getattr(a, attr), getattr(b, attr)
        assert (x is None) == (y is None), attr
        if x is not None:
            assert np.asarray(x).dtype == np.asarray(y).dtype
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), attr


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("name", list(_batches(RecordBatch)))
def test_encode_batch_bytes_equal_jax_and_decode_across(name, compress):
    pb, jb = _batches(RecordBatch)[name], _batches(JaxBatch)[name]
    data = pcodec.encode_batch(pb, compress=compress)
    assert data == jcodec.encode_batch(jb, compress=compress)
    _same_batch(pcodec.decode_batch(data), jb)
    _same_batch(jcodec.decode_batch(data), pb)
    assert type(pcodec.decode_batch(data)) is RecordBatch


def test_decode_reads_jax_zlib_blocks(monkeypatch):
    """JAX's encoder writes zlib blocks (method 2) where its native library
    is missing; the port's decoder reads them."""
    monkeypatch.setattr(jcodec, "native_available", lambda: False)
    jb = _batches(JaxBatch)["ts-keys-groups"]
    data = jcodec.encode_batch(jb)
    assert data != pcodec.encode_batch(_batches(RecordBatch)["ts-keys-groups"])
    _same_batch(pcodec.decode_batch(data), jb)
    with pytest.raises(ValueError, match="magic"):
        pcodec.decode_batch(b"XXXX" + data[4:])


def _rows_batches(RB):
    rng = np.random.default_rng(4)
    return [RB({"a": np.arange(lo, lo + 50, dtype=np.int64),
                "b": np.round(rng.standard_normal(50), 6),
                "s": np.asarray([f"w{i}" for i in range(lo, lo + 50)],
                                object),
                "t": np.arange(lo, lo + 50, dtype=np.int64) * 10})
            for lo in (0, 50, 100)]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["ftb", "csv", "jsonl"])
def test_files_cross_packages(tmp_path, fmt, writer):
    """A file one package writes, the other reads to the same batches (and,
    written by both, the files are byte for byte the same)."""
    pw, jw = pfmt.writer_for(fmt), jfmt.writer_for(fmt)
    pr, jr = pfmt.reader_for(fmt), jfmt.reader_for(fmt)
    p_path, j_path = str(tmp_path / f"p.{fmt}"), str(tmp_path / f"j.{fmt}")
    assert pw(_rows_batches(RecordBatch), p_path) \
        == jw(_rows_batches(JaxBatch), j_path) == 150
    with open(p_path, "rb") as f, open(j_path, "rb") as g:
        assert f.read() == g.read()
    path = j_path if writer == "jax" else p_path
    kw = {} if fmt == "ftb" else {"timestamp_column": "t"}
    got, want = list(pr(path, **kw)), list(jr(path, **kw))
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        assert type(a) is RecordBatch
        _same_batch(a, b)


def test_ftb_append_skip_and_offsets(tmp_path):
    p = str(tmp_path / "a.ftb")
    batches = _rows_batches(RecordBatch)
    pfmt.write_ftb(batches[:2], p)
    pfmt.write_ftb(batches[2:], p, append=True)
    got = list(pfmt.read_ftb(p, skip_batches=1))
    want = list(jfmt.read_ftb(p, skip_batches=1))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _same_batch(a, b)
    offs = [o for _, o in pfmt.read_frames(p)]
    assert offs == [o for _, o in jfmt.read_frames(p)]
    _same_batch(next(pfmt.read_ftb(p, start_offset=offs[1])), want[1])


def test_frames_torn_tail_and_crc(tmp_path):
    import io
    buf = io.BytesIO()
    for payload in (b"alpha", b"", b"x" * 1000):
        pfmt.write_frame(buf, payload)
    data = buf.getvalue()
    jbuf = io.BytesIO()
    for payload in (b"alpha", b"", b"x" * 1000):
        jfmt.write_frame(jbuf, payload)
    assert jbuf.getvalue() == data
    assert list(pfmt.iter_frames(data)) == list(jfmt.iter_frames(data)) \
        == [b"alpha", b"", b"x" * 1000]
    for cut in (3, 9, 20, len(data) - 1):
        assert pfmt.frame_span(data[:cut]) == jfmt.frame_span(data[:cut])
        assert list(pfmt.iter_frames(data[:cut])) \
            == list(jfmt.iter_frames(data[:cut]))
    p = tmp_path / "torn.ftb"
    p.write_bytes(data[:-5])          # torn tail: stops at the last frame
    assert [x for x, _ in pfmt.read_frames(str(p))] == [b"alpha", b""]
    bad = bytearray(data)
    bad[10] ^= 0xFF                    # a flipped payload byte
    p.write_bytes(bytes(bad))
    with pytest.raises(IOError, match="CRC"):
        list(pfmt.read_frames(str(p)))
    with pytest.raises(IOError, match="CRC"):
        list(pfmt.iter_frames(bytes(bad)))


def test_jsonl_numpy_values_and_coercion(tmp_path):
    """``json_default`` writes numpy scalars and arrays as JAX's does; the
    readers' type coercion (int64, float64 with NaN for None, bool,
    object) matches."""
    p = str(tmp_path / "r.jsonl")
    rows = [{"i": 1, "f": 1.5, "b": True, "m": "x", "n": None},
            {"i": 2, "f": None, "b": False, "m": 3, "n": 2.5}]
    with open(p, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    _same_batch(next(pfmt.read_jsonl(p)), next(jfmt.read_jsonl(p)))
    from flink_tpu.connectors.util import json_default as jdef
    from flink_tpu_torch.connectors.util import json_default as pdef
    for v in (np.int64(3), np.float32(0.5), np.arange(3), np.bool_(True)):
        assert json.dumps(v, default=pdef) == json.dumps(v, default=jdef)
    with pytest.raises(TypeError):
        pdef(object())


def test_format_registry():
    assert set(pfmt.FORMATS) == set(jfmt.FORMATS)
    for fmt in pfmt.LATER_FORMATS:
        for fn in (pfmt.reader_for(fmt), pfmt.writer_for(fmt)):
            with pytest.raises(NotImplementedError, match="item 12"):
                fn("x", [])
    with pytest.raises(ValueError, match="unknown format"):
        pfmt.reader_for("xml")
    with pytest.raises(ValueError, match="unknown format"):
        pfmt.writer_for("xml")


def test_failed_codec_build_raises(monkeypatch, tmp_path):
    """With no compiler, or one that fails, the codec raises with the
    compiler's story: no zlib or Python fallback is taken."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    batch = RecordBatch({"v": np.arange(1000, dtype=np.int64)})
    for cxx, match in (("no-such-compiler-here", "not found"),
                       (shutil.which("false") or "false", "false failed")):
        monkeypatch.setattr(build, "HOST_CXX", cxx)
        for call in (lambda: pnat.lz_compress(b"a" * 100),
                     lambda: pnat.crc32(b"abc"),
                     lambda: pnat.delta_varint_encode(np.arange(4)),
                     lambda: pcodec.encode_batch(batch)):
            with pytest.raises(RuntimeError, match=match):
                call()
    assert not list(tmp_path.glob("*.so"))
    assert not os.path.exists(os.path.join(str(tmp_path), "codec.cc"))
