"""Port parity for the binary formats: the reference's cases of
``tests/test_parquet.py``, ``test_orc.py``, ``test_schema_registry.py``
and ``test_foreign_interop.py`` (pyarrow reads the port's files and the
port reads pyarrow's), run through both packages with the harness of
``tests/test_torch_cluster_cases.py``, and the cross-package cases below.
"""

import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case

REFERENCE_FILES = ("test_parquet", "test_orc", "test_schema_registry",
                   "test_foreign_interop")


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(REFERENCE_FILES, marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


# ---------------------------------------------------------------------------
# the same bytes from both packages
# ---------------------------------------------------------------------------

import importlib  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402

#: (format, module, writer, reader, writer options)
FILES = [
    ("avro", "avro", "write_avro", "read_avro", {}),
    ("avro-null", "avro", "write_avro", "read_avro", {"codec": "null"}),
    ("parquet", "parquet", "write_parquet", "read_parquet", {}),
    ("parquet-gzip", "parquet", "write_parquet", "read_parquet",
     {"compression": "gzip", "row_group_rows": 700}),
    ("parquet-plain", "parquet", "write_parquet", "read_parquet",
     {"dictionary": "off"}),
    ("orc", "orc", "write_orc", "read_orc", {"stripe_rows": 900}),
    ("orc-none", "orc", "write_orc", "read_orc", {"compression": "none"}),
    ("seq", "sequencefile", "write_sequencefile", "read_sequencefile",
     {"key_column": "k"}),
]


def _batches(pkg, seed=11, n=2000, parts=3):
    """Seeded batches of every column kind the formats write: int64 and
    int32 keys, f32 and f64 values with NaN and -0.0, bools, strings,
    event time."""
    batch = importlib.import_module(f"{pkg}.core.batch")
    rng = np.random.default_rng(seed)
    out = []
    for i in range(parts):
        k = rng.integers(-5, 1 << 40, n).astype(np.int64)
        f32 = rng.standard_normal(n).astype(np.float32)
        f32[::97] = np.nan
        f64 = rng.standard_normal(n)
        f64[::89] = -0.0
        words = np.asarray([f"w{j % 37}-{i}" for j in range(n)], object)
        cols = {"k": k, "i32": (k % 1000).astype(np.int32),
                "v": f32, "d": f64, "ok": k % 3 == 0, "s": words,
                "ts": np.arange(n, dtype=np.int64) * 7 + i * n * 7}
        out.append(batch.RecordBatch(cols, timestamps=cols["ts"]))
    return out


def _rows(batches):
    rows = []
    for b in batches:
        for r in b.to_rows():
            rows.append({c: (("nan",) if isinstance(v, float) and v != v
                             else v.item() if hasattr(v, "item") else v)
                         for c, v in r.items()})
    return rows


@pytest.mark.parametrize("fmt, mod, writer, reader, opts", FILES,
                         ids=[f[0] for f in FILES])
def test_files_byte_equal_across_packages(fmt, mod, writer, reader, opts,
                                          tmp_path, monkeypatch):
    """The same seeded batches write the same file in both packages (the
    random sync markers of Avro and SequenceFile fixed, and the clock
    gzip stamps each page with, so the two writes cannot straddle a
    second), and each package's reader gives the same rows, dtypes and
    bits for the file the other wrote."""
    import gzip
    import types
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(n)))
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0))
    files = {}
    for pkg in ("flink_tpu", "flink_tpu_torch"):
        m = importlib.import_module(f"{pkg}.formats.{mod}")
        path = str(tmp_path / f"{pkg}.{fmt}")
        assert getattr(m, writer)(_batches(pkg), path, **opts) == 6000
        files[pkg] = path
    with open(files["flink_tpu"], "rb") as a, \
            open(files["flink_tpu_torch"], "rb") as b:
        assert a.read() == b.read()
    read = {}
    for pkg, other in (("flink_tpu", "flink_tpu_torch"),
                       ("flink_tpu_torch", "flink_tpu")):
        m = importlib.import_module(f"{pkg}.formats.{mod}")
        got = list(getattr(m, reader)(files[other]))
        read[pkg] = got
        assert sum(len(b) for b in got) == 6000
    j, p = read["flink_tpu"], read["flink_tpu_torch"]
    assert [{c: np.asarray(v).dtype for c, v in b.columns.items()}
            for b in p] == [{c: np.asarray(v).dtype
                             for c, v in b.columns.items()} for b in j]
    for bj, bp in zip(j, p):
        for c in bj.columns:
            x, y = np.asarray(bj.columns[c]), np.asarray(bp.columns[c])
            assert (x.tobytes() == y.tobytes() if x.dtype != object
                    else x.tolist() == y.tolist()), (fmt, c)
    assert _rows(p) == _rows(j)
    assert len(_rows(p)) == 6000


@pytest.mark.parametrize("fmt", ["avro", "parquet", "orc", "seq", "csv",
                                 "jsonl", "ftb"])
def test_file_source_reads_the_other_packages_files(fmt, tmp_path):
    """``FileSource`` of one package reads a directory of the other's
    files (every format of the registry) into the same rows, split by
    split, from the start and resumed mid-file, positions included."""
    for writer_pkg, reader_pkg in (("flink_tpu", "flink_tpu_torch"),
                                   ("flink_tpu_torch", "flink_tpu")):
        d = tmp_path / f"{writer_pkg}-{fmt}"
        d.mkdir()
        fm = importlib.import_module(f"{writer_pkg}.formats")
        for i, b in enumerate(_batches(writer_pkg, seed=3, n=300,
                                       parts=2)):
            fm.writer_for(fmt)([b], str(d / f"part-{i}.{fmt}"))
        out = {}
        for pkg in (reader_pkg, writer_pkg):
            fs = importlib.import_module(f"{pkg}.connectors.file_source")
            src = fs.FileSource(str(d), format=fmt, timestamp_column="ts",
                                batch_size=128)
            rows, positions = [], []
            for split in src.create_splits(1):
                for start in (0, 150):
                    reader = src.open_split(split, start)
                    for el in reader:
                        if hasattr(el, "to_rows"):
                            rows += _rows([el])
                    positions.append(reader.position)
            out[pkg] = (rows, positions)
        assert out[reader_pkg] == out[writer_pkg]
        assert len(out[reader_pkg][0]) == 900
        assert out[reader_pkg][1] == [300] * 4
