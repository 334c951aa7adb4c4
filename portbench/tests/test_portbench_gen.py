"""The copied generators against values frozen from the originals:
``bench.py``'s ``make_batches`` and ``chip_smoke.py``'s ``rmat_edges``,
each run on the CPU at seed 12345; and the Graphalytics form of an edge
list against its definition."""

import numpy as np
import pytest
import torch

from portbench.lib import gen

UNIFORM = {"batch_size": 1000, "ms_per_batch": 1000, "pool_batches": 4,
           "keys": {"dist": "uniform"}}


def test_uniform_pool_is_bench_make_batches():
    # bench.make_batches(4 * 1000, 1000, 1000, 5000, 12345)
    pool = gen.window_pool(UNIFORM, 1000, 12345)
    assert len(pool) == 4
    assert pool[0][0][:6].tolist() == [699, 227, 788, 316, 204, 797]
    assert pool[1][1][:4].tolist() == [0.7781389951705933, 0.8720654845237732,
                                       0.5847803354263306, 0.23562175035476685]
    assert pool[3][2][:4].tolist() == [3000, 3001, 3002, 3002]
    assert pool[3][2][-2:].tolist() == [3994, 3996]
    assert [int(k.sum()) for k, _, _ in pool] == [491672, 490029, 493515,
                                                  507002]
    sums = [float(v.astype(np.float64).sum()) for _, v, _ in pool]
    assert sums == pytest.approx([488.8667741770041, 495.13349760265555,
                                  481.64048977459606, 495.282507119864],
                                 rel=0, abs=1e-9)
    for keys, vals, ts in pool:
        assert keys.dtype == np.int64 and vals.dtype == np.float32
        assert ts.dtype == np.int64 and np.all(np.diff(ts) >= 0)


def test_unknown_key_distribution_is_refused():
    for dist in ("normal", "zipf"):
        with pytest.raises(ValueError):
            gen.window_pool(dict(UNIFORM, keys={"dist": dist}), 10, 1)


def test_rmat_edges_is_chip_smoke_rmat_edges():
    # chip_smoke.rmat_edges(10, 16, 12345, cpu) with RMAT_ABC
    src, dst = gen.rmat_edges(10, 16, (0.57, 0.19, 0.19), 12345,
                              torch.device("cpu"))
    assert src.dtype == dst.dtype == torch.int32
    assert src.shape == dst.shape == (16 << 10,)
    assert src[:8].tolist() == [840, 1013, 606, 445, 784, 313, 534, 70]
    assert dst[:8].tolist() == [232, 287, 764, 760, 640, 893, 950, 339]
    assert int(src.long().sum()) == 8561373
    assert int(dst.long().sum()) == 8645580


def test_seed_fixes_the_inputs_for_large_seeds():
    seed = 2 ** 31 + 987654321
    a = gen.window_pool(UNIFORM, 1000, seed)
    b = gen.window_pool(UNIFORM, 1000, seed)
    assert all(np.array_equal(x, y) for p, q in zip(a, b)
               for x, y in zip(p, q))
    s1 = gen.rmat_edges(8, 4, (0.57, 0.19, 0.19), seed, torch.device("cpu"))
    s2 = gen.rmat_edges(8, 4, (0.57, 0.19, 0.19), seed, torch.device("cpu"))
    assert torch.equal(s1[0], s2[0]) and torch.equal(s1[1], s2[1])


def test_graphalytics_form_by_hand():
    # 0-1 twice and as 1-0, a self loop on 2, vertex 3 without an edge
    src = torch.tensor([0, 1, 2, 4, 0, 5], dtype=torch.int32)
    dst = torch.tensor([1, 0, 2, 5, 1, 4], dtype=torch.int32)
    n, a, b = gen.graphalytics_form(src, dst, 6)
    assert n == 4                        # 0, 1, 4, 5 -> 0, 1, 2, 3
    assert a.dtype == b.dtype == torch.int32
    assert sorted(zip(a.tolist(), b.tolist())) == [(0, 1), (1, 0), (2, 3),
                                                   (3, 2)]


@pytest.mark.parametrize("scale", [8, 12])
def test_graphalytics_form_of_a_kronecker_graph(scale):
    s, d = gen.rmat_edges(scale, 16, (0.57, 0.19, 0.19), 2 ** 31 + 5,
                          torch.device("cpu"))
    n, a, b = gen.graphalytics_form(s, d, 1 << scale)
    pairs = set(zip(a.tolist(), b.tolist()))
    want = {(min(u, v), max(u, v)) for u, v in zip(s.tolist(), d.tolist())
            if u != v}
    used = sorted({u for e in want for u in e})
    number = {u: i for i, u in enumerate(used)}
    assert n == len(used)
    assert len(pairs) == a.numel() == 2 * len(want)
    assert pairs == {(number[u], number[v]) for u, v in want} | {
        (number[v], number[u]) for u, v in want}


def test_relabel_gives_every_seed_one_graph_in_another_order():
    s, d = gen.rmat_edges(10, 16, (0.57, 0.19, 0.19), 15, torch.device("cpu"))
    forms = []
    for seed in (2 ** 31 + 1, 2 ** 31 + 2):
        a, b = gen.relabel(s, d, 1 << 10, seed)
        assert a.dtype == b.dtype == torch.int32
        forms.append(gen.graphalytics_form(a, b, 1 << 10))
    (n1, a1, b1), (n2, a2, b2) = forms
    assert n1 == n2 and a1.numel() == a2.numel()
    deg1 = torch.bincount(a1.long(), minlength=n1).sort().values
    deg2 = torch.bincount(a2.long(), minlength=n2).sort().values
    assert torch.equal(deg1, deg2)
    assert not torch.equal(a1, a2)
    again = gen.relabel(s, d, 1 << 10, 2 ** 31 + 1)
    assert torch.equal(gen.graphalytics_form(*again, 1 << 10)[1], a1)
