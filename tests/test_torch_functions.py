"""Port parity for the aggregate monoids and the user accumulators: the
cases of ``tests/test_functions.py`` through both packages (the same inputs
folded row by row through ``lift``/``combine``), and accumulators merged
into the ``JobExecutionResult`` of a job on ``LocalExecutor``.  JAX without
x64 narrows a float64 request to f32 (``canonical_acc_dtype``); the port
keeps the dtype asked for, which the last two cases pin."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_tpu.core import functions as jfn
from flink_tpu_torch.core import functions as pfn

SIDES = {
    "jax": dict(fn=jfn, arr=jnp.asarray, i32=jnp.int32,
                flatten=lambda t: jax.tree_util.tree_flatten(t),
                unflatten=jax.tree_util.tree_unflatten),
    "port": dict(fn=pfn, arr=lambda a, dtype=None: torch.as_tensor(
        np.asarray(a), dtype=dtype), i32=torch.int32,
        flatten=lambda t: (pfn.tree_leaves(t), pfn.tree_structure(t)),
        unflatten=pfn.tree_unflatten),
}


@pytest.fixture(params=list(SIDES))
def S(request):
    return SIDES[request.param]


def _fold(S, agg, values):
    acc = agg.identity()
    leaves, treedef = S["flatten"](agg.lift(values))
    for i in range(leaves[0].shape[0]):
        acc = agg.combine(acc, S["unflatten"](treedef,
                                               [l[i] for l in leaves]))
    return agg.get_result(acc)


def test_sum_aggregator(S):
    v = S["arr"](np.array([1.0, 2.5, 3.5], np.float32))
    assert float(_fold(S, S["fn"].SumAggregator(), v)) == 7.0


def test_min_max(S):
    v = S["arr"](np.array([5, -2, 9], np.int32))
    assert int(_fold(S, S["fn"].MinAggregator(S["i32"]), v)) == -2
    assert int(_fold(S, S["fn"].MaxAggregator(S["i32"]), v)) == 9


def test_count(S):
    v = S["arr"](np.array([10.0, 20.0, 30.0], np.float32))
    assert int(_fold(S, S["fn"].CountAggregator(), v)) == 3


def test_avg(S):
    v = S["arr"](np.array([2.0, 4.0, 9.0], np.float32))
    assert float(_fold(S, S["fn"].AvgAggregator(), v)) == 5.0


def test_avg_acc_spec(S):
    spec = S["fn"].AvgAggregator().acc_spec()
    assert spec.num_leaves == 2
    assert set(spec.unflatten(spec.leaf_inits).keys()) == {"sum", "count"}


def test_tuple_aggregator_multifield(S):
    fn = S["fn"]
    agg = fn.TupleAggregator({
        "total": ("price", fn.SumAggregator()),
        "n": ("price", fn.CountAggregator()),
        "biggest": ("qty", fn.MaxAggregator()),
    })
    cols = {"price": S["arr"](np.array([1.0, 2.0, 3.0], np.float32)),
            "qty": S["arr"](np.array([7.0, 1.0, 5.0], np.float32))}
    out = _fold(S, agg, cols)
    assert float(out["total"]) == 6.0 and int(out["n"]) == 3
    assert float(out["biggest"]) == 7.0


def test_lambda_reduce(S):
    one = S["arr"](np.ones((), np.float32))
    r = S["fn"].LambdaReduce(lambda a, b: a * b, one)
    v = S["arr"](np.array([2.0, 3.0, 4.0], np.float32))
    assert float(_fold(S, r, v)) == 24.0


def test_combine_associative_commutative(S):
    agg = S["fn"].AvgAggregator()
    a = {"sum": S["arr"](np.float32(3.0)),
         "count": S["arr"](np.int32(2))}
    b = {"sum": S["arr"](np.float32(5.0)),
         "count": S["arr"](np.int32(1))}
    ab, ba = agg.combine(a, b), agg.combine(b, a)
    assert float(ab["sum"]) == float(ba["sum"]) == 8.0
    assert int(ab["count"]) == int(ba["count"]) == 3


def test_accumulators_merge_into_job_result():
    """User counters merge across operators into the JobExecutionResult,
    in both packages' local executors."""
    from flink_tpu.datastream.api import StreamExecutionEnvironment as JaxEnv
    from flink_tpu.operators.process import KeyedProcessFunction as JaxKPF
    from flink_tpu_torch.datastream.api import StreamExecutionEnvironment
    from flink_tpu_torch.operators.process import KeyedProcessFunction

    results = []
    for env, base in ((JaxEnv(), JaxKPF),
                      (StreamExecutionEnvironment(device="cpu"),
                       KeyedProcessFunction)):
        class P(base):
            def open(self, ctx):
                self.acc = ctx.add_accumulator("rows-seen")

            def process_batch(self, ctx, batch):
                self.acc.add(len(batch))
                return [batch]

        (env.from_collection(columns={"k": np.arange(100) % 3,
                                      "v": np.ones(100)})
         .key_by("k").process(P()).collect())
        results.append(env.execute().get_accumulator_result("rows-seen"))
    assert results == [100, 100]


def test_float64_requests_keep_their_dtype_without_warning():
    """The port has no x64 switch: a float64 request holds float64 leaves
    (JAX without x64 narrows it to f32), and no aggregate warns."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        for agg in (pfn.SumAggregator(torch.float64),
                    pfn.MinAggregator(np.float64),
                    pfn.MaxAggregator("float64"),
                    pfn.AvgAggregator(torch.float64)):
            floats = [l for l in pfn.tree_leaves(agg.identity())
                      if l.dtype.is_floating_point]
            assert floats and all(l.dtype == torch.float64 for l in floats)


def test_explicit_float32_request_unchanged():
    assert pfn.SumAggregator(torch.float32).identity().dtype == torch.float32
    assert jfn.SumAggregator(jnp.float32).identity().dtype == jnp.float32
