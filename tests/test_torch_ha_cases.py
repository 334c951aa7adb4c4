"""Port parity for high availability and the TCP data plane: the
reference's cases of ``tests/test_ha.py`` and ``tests/test_net.py``, run
through both packages with the harness of
``tests/test_torch_cluster_cases.py``, each keeping its reference marks.

The HA store's records (lease, epoch counter, job registry, completed
checkpoint pointer) are written and read by each package's own
``runtime/ha.py``; the cross-package cases at the end hold that a store
directory either package wrote serves the other.  The data plane's batches
travel as the port's FTB frames (``native/codec.py`` over
``csrc/codec.cc``), so a JAX writer and a port reader (and the other way
round) share one channel.  ``test_coordinator_kill_at_peak_recovers_
exactly_once`` drives the fraud scenario's HA kill (``scenarios/
harness.py`` ``run_ha_kill``) on each package: leader A killed at its lease
renewal at the diurnal peak, standby B at epoch + 1 restoring from the HA
pointer, the zombie's completions and a stale-epoch 2PC commit fenced, the
committed Kafka rows equal to an unfaulted control's.
"""

import numpy as np
import pytest

import flink_tpu_torch.cluster.distributed  # noqa: F401 — patched by the harness
from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(("test_ha", "test_net"), marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


# ---------------------------------------------------------------------------
# one HA store directory, both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ha_store_directory_serves_the_other_package(tmp_path, writer):
    """A leader of one package acquires the lease, registers a job and
    advances the completed-checkpoint pointer; the other package's store
    reads the same records, fences the old epoch and takes over at
    epoch + 1 — the records are byte for byte the same format."""
    from flink_tpu.runtime import ha as jax_ha
    from flink_tpu_torch.runtime import ha as port_ha
    w, r = (jax_ha, port_ha) if writer == "jax" else (port_ha, jax_ha)
    a = w.FileHaStore(str(tmp_path))
    lease = a.acquire("leader-a", ttl_s=0.2)
    a.register_job("job_mod_build", {"job": "job_mod:build", "n_workers": 2,
                                     "settings": {"incremental": True}},
                   lease.epoch)
    a.set_completed_checkpoint("job_mod_build", 7, lease.epoch)
    b = r.FileHaStore(str(tmp_path))
    assert b.current_epoch() == lease.epoch
    assert b.read_lease().holder == "leader-a"
    assert b.load_job("job_mod_build")["settings"] == {"incremental": True}
    assert b.completed_checkpoint("job_mod_build")["checkpoint_id"] == 7
    assert b.job_ids() == ["job_mod_build"]
    import time
    time.sleep(0.3)
    lease_b = b.acquire("leader-b", ttl_s=5.0)
    assert lease_b.epoch == lease.epoch + 1
    with pytest.raises(r.StaleEpochError):
        b.set_completed_checkpoint("job_mod_build", 9, lease.epoch)
    with pytest.raises(w.StaleEpochError):
        a.set_completed_checkpoint("job_mod_build", 9, lease.epoch)
    assert a.completed_checkpoint("job_mod_build")["checkpoint_id"] == 7


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tcp_channel_between_packages(writer):
    """A ``RemoteChannel`` of one package feeds the ``ChannelServer`` of the
    other: batches (FTB frames), watermarks, barriers and the end of input
    arrive as the writer sent them, under the HMAC handshake."""
    from flink_tpu.cluster import net as jax_net
    from flink_tpu.core import batch as jax_batch
    from flink_tpu_torch.cluster import net as port_net
    from flink_tpu_torch.core import batch as port_batch
    srv_mod, w_mod, b = ((port_net, jax_net, jax_batch) if writer == "jax"
                         else (jax_net, port_net, port_batch))
    server = srv_mod.ChannelServer(auth_token="s3cret")
    try:
        w = w_mod.RemoteChannel(server.host, server.port, "x",
                                auth_token="s3cret")
        rng = np.random.default_rng(3)
        sent = []
        for i in range(5):
            cols = {"k": rng.integers(0, 1 << 40, 300),
                    "v": rng.random(300).astype(np.float32)}
            sent.append(cols)
            assert w.put(b.RecordBatch(cols, timestamps=np.arange(300)),
                         timeout_s=30)
        assert w.put(b.Watermark(1234), timeout_s=30)
        assert w.put(b.CheckpointBarrier(5, 99), timeout_s=30)
        assert w.put(b.EndOfInput(), timeout_s=30)
        q = server.channel("x")
        got = [q.poll(timeout_s=30) for _ in range(8)]
        for cols, el in zip(sent, got[:5]):
            assert type(el).__name__ == "RecordBatch"
            for c in cols:
                np.testing.assert_array_equal(np.asarray(el.column(c)),
                                              cols[c])
            np.testing.assert_array_equal(np.asarray(el.timestamps),
                                          np.arange(300))
        assert type(got[5]).__name__ == "Watermark"
        assert got[5].timestamp == 1234
        assert type(got[6]).__name__ == "CheckpointBarrier"
        assert got[6].checkpoint_id == 5
        assert type(got[7]).__name__ == "EndOfInput"
        w.close()
    finally:
        server.stop()
