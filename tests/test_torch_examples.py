"""Port parity for the user programs: each of ``examples/`` and its port in
``flink_tpu_torch/examples/`` run on the same seeded input, the port's on
the CPU, and give the same output (the word counts and the alerts exactly,
as numpy counts them too)."""

import contextlib
import io
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"


def _jax_example(name: str, patches=()):
    """The namespace of ``examples/<name>.py`` (its ``__main__`` block not
    run), with ``(old, new)`` text replacements applied."""
    src = (EXAMPLES / f"{name}.py").read_text()
    for old, new in patches:
        assert old in src, old
        src = src.replace(old, new)
    ns = {"__name__": f"jax_example_{name}",
          "__file__": str(EXAMPLES / f"{name}.py")}
    exec(compile(src, str(EXAMPLES / f"{name}.py"), "exec"), ns)
    return ns


def test_wordcount_batch_prints_what_jax_prints():
    from flink_tpu_torch.examples import wordcount_batch
    out = {}
    for side in ("jax", "port"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if side == "jax":
                _jax_example("wordcount_batch")["main"]()
            else:
                top = wordcount_batch.main(device="cpu")
        out[side] = buf.getvalue().splitlines()
    assert out["port"] == out["jax"]
    words = np.asarray(wordcount_batch.TEXT, object)
    u, c = np.unique(words, return_counts=True)
    want = dict(zip(u.tolist(), c.tolist()))
    assert [r["count"] for r in top] == sorted(want.values())[::-1][:5]
    assert all(want[r["word"]] == r["count"] for r in top)


def _text_server(text: str) -> int:
    """A one-shot TCP server on a free local port: sends ``text`` to its
    first client and closes."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        with srv:
            conn, _ = srv.accept()
            with conn:
                conn.sendall(text.encode())

    threading.Thread(target=serve, daemon=True).start()
    return srv.getsockname()[1]


def test_socket_window_word_count_equals_jax(monkeypatch):
    """Both programs read the same seeded text (200,000 Zipf words over
    1000) from a local socket; their windows are processing-time, so the
    comparison is each word's count summed over its windows: equal in both
    packages and to numpy's."""
    from flink_tpu.datastream import api as jax_api
    from flink_tpu.datastream.api import StreamExecutionEnvironment as JaxEnv
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.examples import socket_window_word_count
    rng = np.random.default_rng(5)
    vocab = np.asarray([f"w{i}" for i in range(1000)], object)
    words = vocab[rng.zipf(1.3, 200_000) % 1000]
    text = "\n".join(" ".join(words[i:i + 10])
                     for i in range(0, words.size, 10)) + "\n"
    u, c = np.unique(words, return_counts=True)
    want = dict(zip(u.tolist(), c.tolist()))
    sinks = []
    real = jax_api.DataStream.print

    def print_and_collect(self, *a, **kw):
        sinks.append(self.collect())
        return real(self, *a, **kw)

    monkeypatch.setattr(jax_api.DataStream, "print", print_and_collect)
    got = {}
    for side in ("jax", "port"):
        port = _text_server(text)
        with contextlib.redirect_stdout(io.StringIO()):
            if side == "jax":
                env = JaxEnv()
                _jax_example("socket_window_word_count", (
                    ('socket_text_stream("localhost", 9999)',
                     f'socket_text_stream("127.0.0.1", {port})'),))["main"](
                    env)
                (sink,) = sinks
            else:
                env = StreamExecutionEnvironment(device="cpu")
                sink = socket_window_word_count.main(env, "127.0.0.1", port)
            env.execute()
        totals = {}
        for r in sink.rows():
            totals[r["word"]] = totals.get(r["word"], 0) + int(r["count"])
        got[side] = totals
    assert got["port"] == got["jax"] == want


def test_fraud_detection_alerts_equal_jax():
    """The walkthrough's 10,000 transactions through both packages: the
    same alerts, exactly the three planted accounts."""
    from flink_tpu.datastream.api import StreamExecutionEnvironment as JaxEnv
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.examples import fraud_detection
    got = {}
    for side in ("jax", "port"):
        with contextlib.redirect_stdout(io.StringIO()):
            if side == "jax":
                env = JaxEnv()
                sink = _jax_example("fraud_detection")["main"](env)
            else:
                env = StreamExecutionEnvironment(device="cpu")
                sink = fraud_detection.main(env)
            env.execute()
        got[side] = sorted((int(r["account"]), float(r["bait"]),
                            float(r["amount"])) for r in sink.rows())
    assert got["port"] == got["jax"]
    assert [a for a, _, _ in got["port"]] == \
        [a for a, _ in fraud_detection.PLANTED] == [7, 21, 33]


def test_distributed_wordcount_equals_jax(monkeypatch):
    """Both programs' keyed sums on a 2-worker process cluster: every one
    of the 1000 words counts 100 in both."""
    from flink_tpu.cluster.distributed import ProcessCluster
    from flink_tpu_torch.examples import distributed_wordcount
    with contextlib.redirect_stdout(io.StringIO()):
        res, final = distributed_wordcount.main(device="cpu",
                                                timeout_s=240)
    assert res["state"] == "FINISHED"
    monkeypatch.syspath_prepend(str(EXAMPLES))   # the job's module
    pc = ProcessCluster("distributed_wordcount:build", n_workers=2,
                        extra_sys_path=(str(EXAMPLES), str(REPO)))
    jres = pc.run(timeout_s=240)
    assert jres["state"] == "FINISHED"
    jfinal = {}
    for r in jres["rows"]:
        jfinal[r["word"]] = r["count"]
    assert {int(k): float(v) for k, v in final.items()} == \
        {int(k): float(v) for k, v in jfinal.items()} == \
        {w: 100.0 for w in range(1000)}


def test_cli_runs_the_fraud_example_without_jax():
    """``python -m flink_tpu_torch run flink_tpu_torch/examples/
    fraud_detection.py`` in an interpreter where ``jax`` and ``flink_tpu``
    cannot be imported: three alerts."""
    code = ("import sys\n"
            "for m in ('jax', 'flink_tpu', 'pandas'):\n"
            "    sys.modules[m] = None\n"
            "from flink_tpu_torch.__main__ import main\n"
            "sys.exit(main(['run', 'flink_tpu_torch/examples/"
            "fraud_detection.py', '--device', 'cpu']))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    alerts = [l for l in res.stdout.splitlines() if l.startswith("ALERT")]
    assert len(alerts) == 3 and "job finished" in res.stdout


def test_examples_default_to_the_card(monkeypatch):
    """Without a card, the examples not told ``device='cpu'`` refuse
    rather than run on the CPU: the distributed one when its coordinator
    resolves the workers' device, the CLI's environment (the socket and
    fraud examples') when it resolves its operators' device; the batch
    one's environment leaves its device to the card."""
    import torch

    from flink_tpu_torch.dataset import ExecutionEnvironment
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.examples import distributed_wordcount
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed_wordcount.main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamExecutionEnvironment().operator_device()
    assert ExecutionEnvironment.get_execution_environment().device is None
