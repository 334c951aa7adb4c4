"""Port parity for per-slot managed memory (``runtime/memory.py``, the
``MemoryManager.java`` analog): the accounting cases of
``tests/test_memory_manager.py`` through both packages (``side``), and the
slot's manager handed to a keyed process function by the local executor.
The spill-backend cases are in ``tests/test_torch_spill_state.py``."""

import numpy as np
import pytest

from flink_tpu.config import config_option as jco
from flink_tpu.config import options as jopts
from flink_tpu.runtime import memory as jmem
from flink_tpu_torch.config import config_option as pco
from flink_tpu_torch.config import options as popts
from flink_tpu_torch.runtime import memory as pmem

SIDES = {"jax": (jmem, jco, jopts), "port": (pmem, pco, popts)}


@pytest.fixture(params=list(SIDES))
def side(request):
    return SIDES[request.param]


def test_reserve_release_cycle(side):
    mem = side[0]
    mm = mem.MemoryManager(100)
    r1 = mm.reserve("sort", 60)
    assert mm.available() == 40 and mm.used() == 60
    r2 = mm.reserve("hash", 40)
    assert mm.available() == 0
    r1.release()
    assert mm.available() == 60
    r1.release()                      # idempotent
    assert mm.available() == 60
    r2.release()
    assert mm.usage_by_owner() == {}


def test_over_commit_fails_fast(side):
    mem = side[0]
    mm = mem.MemoryManager(100)
    mm.reserve("a", 80)
    with pytest.raises(mem.MemoryReservationError, match="requested 30"):
        mm.reserve("b", 30)
    assert mm.available() == 20
    mm.reserve("b", 20)


def test_release_all_for_owner(side):
    mm = side[0].MemoryManager(100)
    mm.reserve("op", 30)
    mm.reserve("op", 20)
    mm.reserve("other", 10)
    assert mm.release_all("op") == 50
    assert mm.available() == 90
    assert mm.usage_by_owner() == {"other": 10}


def test_context_manager_releases(side):
    mm = side[0].MemoryManager(64)
    with mm.reserve("tmp", 64):
        assert mm.available() == 0
    assert mm.available() == 64


def test_operator_share_weights(side):
    mm = side[0].MemoryManager(1000)
    w = {"sort": 3.0, "hash": 1.0}
    assert mm.compute_operator_share(w, "sort") == 750
    assert mm.compute_operator_share(w, "hash") == 250
    assert mm.compute_operator_share(w, "absent") == 0


def test_slot_split(side):
    mem, co, o = side
    slots = mem.slot_memory_managers(100, 4)
    assert [s.total for s in slots] == [25] * 4
    cfg = co.Configuration()
    cfg.set(o.TaskManagerOptions.MANAGED_MEMORY_SIZE, 128)
    assert mem.memory_manager_for(cfg, num_slots=2).total == 64
    cfg.set(o.TaskManagerOptions.NUM_TASK_SLOTS, 4)
    assert mem.memory_manager_for(cfg).total == 32
    assert mem.memory_manager_for(None).total == 256 << 20


def test_release_after_release_all_does_not_double_free(side):
    mem = side[0]
    mm = mem.MemoryManager(100)
    r = mm.reserve("op", 60)
    assert mm.release_all("op") == 60
    r.release()
    assert mm.used() == 0 and mm.available() == 100
    mm.reserve("later", 100)
    with pytest.raises(mem.MemoryReservationError):
        mm.reserve("later", 1)


def test_slot_pool_bounds_aggregate_memory(side):
    mem, co, o = side
    cfg = co.Configuration()
    cfg.set(o.TaskManagerOptions.MANAGED_MEMORY_SIZE, 100)
    cfg.set(o.TaskManagerOptions.NUM_TASK_SLOTS, 2)
    pool = mem.SlotMemoryPool(cfg)
    assigned = [pool.assign() for _ in range(10)]
    assert len({id(m) for m in assigned}) == 2
    assert sum(m.total for m in pool.slots) == 100


def test_pipeline_process_function_sees_the_slot_manager():
    """End to end on the port: the local executor hands every operator its
    slot's manager, sized from the job's configuration."""
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.operators.process import KeyedProcessFunction

    cfg = pco.Configuration()
    cfg.set(popts.TaskManagerOptions.MANAGED_MEMORY_SIZE, 1 << 20)
    seen = []

    class Probe(KeyedProcessFunction):
        def open(self, ctx):
            seen.append(ctx.memory_manager)

        def process_batch(self, ctx, batch):
            return [batch]

    env = StreamExecutionEnvironment(config=cfg, device="cpu")
    (env.from_collection(columns={"k": np.arange(10) % 3, "v": np.ones(10)})
     .key_by("k").process(Probe()).collect())
    env.execute()
    assert len(seen) == 1 and seen[0].total == 1 << 20
