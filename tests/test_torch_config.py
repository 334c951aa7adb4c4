"""Port parity for the typed configuration: ``flink_tpu_torch.config``
against ``flink_tpu.config``, every case of ``tests/test_config.py`` run
through both packages (``side``), plus the option tables compared key by
key (name, type, default)."""

import pytest

from flink_tpu.config import config_option as jco
from flink_tpu.config import options as jopts
from flink_tpu_torch.config import config_option as pco
from flink_tpu_torch.config import options as popts

SIDES = {"jax": (jco, jopts), "port": (pco, popts)}


@pytest.fixture(params=list(SIDES))
def side(request):
    return SIDES[request.param]


def test_typed_option_defaults(side):
    co, o = side
    conf = co.Configuration()
    assert conf.get(o.CoreOptions.MAX_PARALLELISM) == 128
    assert conf.get(o.ExecutionOptions.MICRO_BATCH_SIZE) == 65536
    assert conf.get(o.CheckpointingOptions.MODE) == "EXACTLY_ONCE"


def test_set_get_parsing(side):
    co, o = side
    conf = co.Configuration()
    conf.set(o.CoreOptions.MAX_PARALLELISM, "256")
    assert conf.get(o.CoreOptions.MAX_PARALLELISM) == 256
    conf.set(o.StateOptions.INCREMENTAL, "true")
    assert conf.get(o.StateOptions.INCREMENTAL) is True
    conf.set(o.CheckpointingOptions.INTERVAL, "5 s")
    assert conf.get(o.CheckpointingOptions.INTERVAL) == 5000


def test_duration_and_memory_parsers(side):
    co, _ = side
    assert co.parse_duration_ms("500 ms") == 500
    assert co.parse_duration_ms("2 min") == 120_000
    assert co.parse_duration_ms(250) == 250
    assert co.parse_duration_ms("1.5 s") == 1500
    assert co.parse_memory_bytes("32 kb") == 32 * 1024
    assert co.parse_memory_bytes("1g") == 1 << 30
    assert co.parse_memory_bytes(4096) == 4096


def test_fallback_and_deprecated_keys(side):
    co, _ = side
    opt = co.key("new.key").int_type().default_value(7) \
        .with_deprecated_keys("old.key")
    conf = co.Configuration({"old.key": "42"})
    assert conf.get(opt) == 42
    conf.set(opt, 13)
    assert conf.get(opt) == 13


def test_yaml_loading(side, tmp_path):
    co, o = side
    p = tmp_path / "flink-conf.yaml"
    p.write_text("# comment\npipeline.max-parallelism: 64\n"
                 "state.backend: hbm\n")
    conf = co.Configuration.from_yaml_file(str(p))
    assert conf.get(o.CoreOptions.MAX_PARALLELISM) == 64
    assert conf.get(o.StateOptions.BACKEND) == "hbm"


def test_clone_independent(side):
    co, _ = side
    a = co.Configuration({"x": 1})
    b = a.clone()
    b.set("x", 2)
    assert a.get("x") == 1


def test_remove_clears_all_keys(side):
    co, _ = side
    opt = co.key("new.key").int_type().default_value(7) \
        .with_deprecated_keys("old.key")
    conf = co.Configuration({"old.key": "42", "new.key": "43"})
    conf.remove(opt)
    assert conf.get(opt) == 7
    assert not conf.contains(opt)


def test_from_env_dash_keys(side, monkeypatch):
    co, o = side
    monkeypatch.setenv("FLINK_TPU_PIPELINE_MAX__PARALLELISM", "256")
    conf = co.Configuration.from_env()
    assert conf.get(o.CoreOptions.MAX_PARALLELISM) == 256


def _options(mod):
    out = {}
    for cname in dir(mod):
        cls = getattr(mod, cname)
        if isinstance(cls, type) and cname.endswith("Options"):
            for aname in dir(cls):
                opt = getattr(cls, aname)
                if hasattr(opt, "key") and hasattr(opt, "default"):
                    out[(cname, aname)] = (opt.key, repr(opt.default))
    return out


def test_option_tables_equal_jax():
    """Every option group of the port names the same keys with the same
    defaults as JAX's, so a configuration file means the same to both."""
    want, got = _options(jopts), _options(popts)
    assert got == want and len(got) > 40
