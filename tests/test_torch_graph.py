"""Port parity for the graph library: ``flink_tpu_torch.graph_lib.Graph``
against ``flink_tpu.graph_lib.Graph`` on the CPU, every case of
``tests/test_graph_lib.py`` on both packages' graphs built from the same
numpy edges.

Tolerances:

- Exact (``np.array_equal``, dtypes too): degrees, connected components,
  BFS levels, SSSP, label propagation, k-core, triangles, clustering,
  summarization, bipartite projections, the all-pairs family, Jaccard
  (integer counts in f32) and every custom ``scatter_gather`` whose
  combine is a min or max.  Their results do not depend on the order of
  a sum, or are integers.
- PageRank and HITS: ``RANK_RTOL``.  Their per-vertex sums fold in edge
  order in both packages (index_add_ and XLA's CPU scatter are
  sequential), but the dangling mass (``sum``) and the norms
  (``linalg.norm``) are reductions that torch and XLA group differently.
  Measured on random graphs of 30 to 1000 vertices: at most 4.3e-7
  relative (PageRank), 3.7e-7 (HITS), a few f32 ulps.
- Adamic-Adar: ``SCORE_RTOL``: an f32 matmul of ``1/log(deg)`` weights,
  summed in torch's order against Eigen's (measured at most 2.2e-7).
- The mesh: the port's ``make_mesh(devices=["cpu"] * D)`` for D = 1, 2,
  4, 8 against JAX's ``make_mesh(8)``: min/max combines exactly, sums to
  ``RANK_RTOL`` (the partials merge in shard order, XLA's ``psum`` in its
  own).  The port's mesh at D = 1 equals its own single-device
  ``scatter_gather`` bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu.graph_lib import Graph as JaxGraph
from flink_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flink_tpu_torch.graph_lib import Graph
from flink_tpu_torch.graph_lib import graph as pgraph
from flink_tpu_torch.parallel.mesh import make_mesh

#: PageRank and HITS against JAX (reductions grouped differently)
RANK_RTOL = 1e-6
RANK_ATOL = 1e-9
#: Adamic-Adar's f32 product against JAX's
SCORE_RTOL = 1e-6
MESH_SIZES = [1, 2, 4, 8]


def both(edges, num_vertices=None, weights=None):
    """(JAX graph, port graph on the CPU) from the same numpy edges."""
    return (JaxGraph.from_edges(edges, num_vertices=num_vertices,
                                weights=weights),
            Graph.from_edges(edges, num_vertices=num_vertices,
                             weights=weights, device="cpu"))


def equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def close(got, want, rtol=RANK_RTOL, atol=RANK_ATOL):
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def cpu_mesh(d):
    return make_mesh(devices=["cpu"] * d)


def edge_map(g):
    return {(int(s), int(d)): float(w) for s, d, w in
            zip(np.asarray(g.src), np.asarray(g.dst), np.asarray(g.weights))}


def random_edges(seed, n, e):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)


# ---------------------------------------------------------------------------
# the cases of tests/test_graph_lib.py
# ---------------------------------------------------------------------------

def test_degrees():
    j, p = both([(0, 1), (0, 2), (1, 2)])
    equal(p.out_degrees(), j.out_degrees())
    equal(p.in_degrees(), j.in_degrees())
    assert p.out_degrees().tolist() == [2, 1, 0]


def test_pagerank_star():
    j, p = both([(1, 0), (2, 0), (3, 0)])
    pr = p.pagerank(num_iterations=50)
    close(pr, j.pagerank(num_iterations=50))
    assert pr[0] > pr[1] == pytest.approx(pr[2], rel=1e-5)
    assert pr.sum() == pytest.approx(1.0, abs=1e-3)


def test_pagerank_matches_power_iteration():
    rng = np.random.default_rng(3)
    n, m = 30, 120
    edges = rng.integers(0, n, (m, 2))
    j, p = both(edges, num_vertices=n)
    pr = p.pagerank(num_iterations=100)
    close(pr, j.pagerank(num_iterations=100))
    A = np.zeros((n, n))
    for s, d in edges:
        A[d, s] += 1
    deg = A.sum(axis=0)
    P = np.where(deg > 0, A / np.maximum(deg, 1), 1.0 / n)
    r = np.full(n, 1.0 / n)
    for _ in range(100):
        r = (1 - 0.85) / n + 0.85 * P @ r
    np.testing.assert_allclose(pr, r, atol=1e-3)


def test_pagerank_tol_stops_like_jax():
    j, p = both(random_edges(4, 50, 300), num_vertices=50)
    close(p.pagerank(num_iterations=200, tol=1e-4),
          j.pagerank(num_iterations=200, tol=1e-4))


def test_connected_components():
    j, p = both([(0, 1), (1, 2), (3, 4)], num_vertices=6)
    cc = p.connected_components()
    equal(cc, j.connected_components())
    assert cc.tolist() == [0, 0, 0, 3, 3, 5]


def test_sssp_weighted():
    j, p = both([(0, 1), (1, 2), (0, 2)], weights=[1.0, 1.0, 5.0])
    d = p.sssp(0)
    equal(d, j.sssp(0))
    assert d[0] == 0 and d[1] == 1.0 and d[2] == 2.0


def test_sssp_unreachable_is_inf():
    j, p = both([(0, 1)], num_vertices=3)
    d = p.sssp(0)
    equal(d, j.sssp(0))
    assert np.isinf(d[2])


def test_triangle_count_dense_and_sparse_agree():
    rng = np.random.default_rng(7)
    edges = set()
    while len(edges) < 60:
        a, b = rng.integers(0, 20, 2)
        if a != b:
            edges.add((min(a, b), max(a, b)))
    e = np.asarray(sorted(edges))
    j, p = both(e, num_vertices=20)
    dense = p.triangle_count()
    assert dense == j.triangle_count()
    adj = {i: set() for i in range(20)}
    for a, b in e.tolist():
        adj[a].add(b)
        adj[b].add(a)
    brute = sum(1 for a in range(20) for b in adj[a] if b > a
                for c in (adj[a] & adj[b]) if c > b)
    assert dense == brute > 0
    # the sparse branch (n > 2048) on the same edges
    assert Graph.from_edges(e, num_vertices=3000,
                            device="cpu").triangle_count() == brute


def test_triangle_known():
    j, p = both([(0, 1), (1, 2), (2, 0), (2, 3)])
    assert p.triangle_count() == j.triangle_count() == 1


def test_label_propagation():
    j, p = both([(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5)])
    labels = p.label_propagation(np.arange(6), num_iterations=10)
    equal(labels, j.label_propagation(np.arange(6), num_iterations=10))
    assert labels[0] == labels[1] == labels[2]
    assert labels[3] == labels[4] == labels[5]
    assert labels[0] != labels[3]


def test_scatter_gather_custom():
    j, p = both([(0, 2), (1, 2)])
    init = np.array([1.0, 2.0, 0.0], np.float32)
    vals = p.scatter_gather(init, lambda sv, w: sv, "sum",
                            lambda v, c: v + c, max_supersteps=1)
    equal(vals, j.scatter_gather(init, lambda sv, w: sv, "sum",
                                 lambda v, c: v + c, max_supersteps=1))
    assert vals.tolist() == [1.0, 2.0, 3.0]


def test_dataset_interop():
    """``from_dataset`` takes any object with ``collect_batch()`` (JAX's
    DataSet or the port's); ``as_dataset`` gives JAX's columns, dtypes and
    rows, in an environment on the graph's device."""
    from flink_tpu.dataset import ExecutionEnvironment
    from flink_tpu_torch.dataset import ExecutionEnvironment as PortEnv

    cols = {"src": [0, 1], "dst": [1, 2], "w": [1.0, 2.0]}
    j = JaxGraph.from_dataset(ExecutionEnvironment().from_columns(cols),
                              weight_column="w")
    p = Graph.from_dataset(PortEnv(device="cpu").from_columns(cols),
                           weight_column="w", device="cpu")
    assert p.num_edges == j.num_edges == 2 and p.n == j.n == 3
    equal(p.weights.numpy(), np.asarray(j.weights))
    for pg, jg in ((p, j), (p.undirected(), j.undirected()),
                   (Graph.from_edges([(0, 1), (2, 0)], device="cpu"),
                    JaxGraph.from_edges([(0, 1), (2, 0)]))):
        pd, jd = pg.as_dataset(), jg.as_dataset()
        assert pd.env.device == pg.device
        pb, jb = pd.collect_batch(), jd.collect_batch()
        assert list(pb.columns) == list(jb.columns)
        for c in jb.columns:
            equal(np.asarray(pb.column(c)), np.asarray(jb.column(c)))
        assert pd.collect() == jd.collect()
    back = p.as_dataset().collect()
    assert len(back) == 2 and back[0]["weight"] == 1.0


def test_empty_graph():
    j, p = both([])
    assert p.n == j.n == 0 and p.num_edges == j.num_edges == 0
    equal(p.out_degrees(), j.out_degrees())
    equal(p.connected_components(), j.connected_components())


def test_k_core():
    edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3),
             (3, 4), (4, 5)]
    j, p = both(edges, num_vertices=6)
    equal(p.k_core(3), j.k_core(3))
    assert p.k_core(3).tolist() == [True, True, True, True, False, False]
    assert p.k_core(1).tolist() == [True] * 6


def test_clustering_coefficient():
    j, p = both([(0, 1), (1, 2), (0, 2), (0, 3)], num_vertices=4)
    cc = p.clustering_coefficient()
    equal(cc, j.clustering_coefficient())
    assert cc[1] == 1.0 and cc[2] == 1.0
    assert abs(cc[0] - 1 / 3) < 1e-9
    assert cc[3] == 0.0


def test_bfs_levels_multi_source():
    j, p = both([(0, 1), (1, 2), (2, 3), (3, 4)], num_vertices=6)
    lv = p.bfs_levels(0)
    equal(lv, j.bfs_levels(0))
    assert lv.tolist() == [0, 1, 2, 3, 4, -1]
    lv2 = p.bfs_levels(np.array([0, 4]))
    equal(lv2, j.bfs_levels(np.array([0, 4])))
    assert lv2.tolist() == [0, 1, 2, 1, 0, -1]


def test_k_core_bidirectional_edge_list():
    j, p = both([(0, 1), (1, 0), (1, 2), (2, 1)], num_vertices=3)
    equal(p.k_core(2), j.k_core(2))
    assert p.k_core(2).tolist() == [False, False, False]
    assert p.k_core(1).tolist() == [True, True, True]


def test_bfs_levels_directed_flag():
    j, p = both([(1, 0)], num_vertices=2)
    equal(p.bfs_levels(0), j.bfs_levels(0))
    equal(p.bfs_levels(0, directed=True), j.bfs_levels(0, directed=True))
    assert p.bfs_levels(0, directed=True).tolist() == [0, -1]


@pytest.mark.parametrize("D", MESH_SIZES)
def test_mesh_pagerank_matches_single_device(D):
    n, e = 300, 2_000
    j, p = both(random_edges(6, n, e), num_vertices=n)
    want = j.pagerank(num_iterations=25, mesh=jax_make_mesh(8))
    got = p.pagerank(num_iterations=25, mesh=cpu_mesh(D))
    close(got, want)
    np.testing.assert_allclose(got, p.pagerank(num_iterations=25),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("D", MESH_SIZES)
def test_mesh_connected_components_matches(D):
    j, p = both([(0, 1), (1, 2), (3, 4)], num_vertices=6)
    want = j.undirected().scatter_gather(
        jnp.arange(6, dtype=jnp.int32), lambda v, _w: v, "min",
        lambda v, c: jnp.minimum(v, c), 6, mesh=jax_make_mesh(8))
    got = p.undirected().scatter_gather(
        torch.arange(6, dtype=torch.int32), lambda v, _w: v, "min",
        lambda v, c: torch.minimum(v, c), 6, mesh=cpu_mesh(D))
    equal(got, want)
    equal(got, p.connected_components())


@pytest.mark.parametrize("D", MESH_SIZES)
def test_mesh_weighted_sssp_matches(D):
    w = np.asarray([1.0, 1.0, 5.0], np.float32)
    j, p = both([(0, 1), (1, 2), (0, 2)], num_vertices=3, weights=w)
    inf = np.float32(np.inf)
    init = np.asarray([0.0, inf, inf], np.float32)
    want = j.scatter_gather(jnp.asarray(init), lambda v, w_: v + w_, "min",
                            lambda v, c: jnp.minimum(v, c), 4,
                            mesh=jax_make_mesh(8))
    got = p.scatter_gather(init, lambda v, w_: v + w_, "min",
                           lambda v, c: torch.minimum(v, c), 4,
                           mesh=cpu_mesh(D))
    equal(got, want)
    equal(got, p.sssp(0))


def test_hits_hub_authority():
    j, p = both([(0, 2), (1, 2)])
    hubs, auth = p.hits(num_iterations=10)
    jh, ja = j.hits(num_iterations=10)
    close(hubs, jh)
    close(auth, ja)
    assert auth.argmax() == 2
    assert hubs[0] == pytest.approx(hubs[1])
    assert hubs[2] == pytest.approx(0.0, abs=1e-6)
    assert auth[2] == pytest.approx(1.0, rel=1e-5)


def test_hits_random_graph():
    j, p = both(random_edges(12, 80, 500), num_vertices=80)
    for a, b in zip(p.hits(num_iterations=20), j.hits(num_iterations=20)):
        close(a, b)


def test_jaccard_similarity_hand_computed():
    j, p = both([(0, 1), (1, 2), (0, 2), (2, 3)])
    sim = p.jaccard_similarity()
    equal(sim, j.jaccard_similarity())
    assert sim[0] == pytest.approx(1 / 3)
    assert sim[3] == pytest.approx(0.0)


def test_jaccard_dense_and_sparse_agree():
    e = random_edges(3, 60, 300)
    j, p = both(e, num_vertices=60)
    dense = p.jaccard_similarity()
    equal(dense, j.jaccard_similarity())
    adj = {}
    for s_, d in e.tolist():
        if s_ == d:
            continue
        adj.setdefault(s_, set()).add(d)
        adj.setdefault(d, set()).add(s_)
    sparse = []
    for s_, d in e.tolist():
        ns, nd = adj.get(s_, set()), adj.get(d, set())
        u = len(ns | nd)
        sparse.append(len(ns & nd) / u if u else 0.0)
    np.testing.assert_allclose(dense, sparse, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("D", MESH_SIZES)
def test_mesh_vector_values_match_single_device(D):
    rng = np.random.default_rng(9)
    n, e, k = 40, 160, 3
    j, p = both(random_edges(9, n, e), num_vertices=n)
    init = rng.random((n, k)).astype(np.float32)
    want = j.scatter_gather(init, lambda v, _w: v * 0.5, "sum",
                            lambda v, c: v * 0.1 + c, 3,
                            mesh=jax_make_mesh(8))
    got = p.scatter_gather(init, lambda v, _w: v * 0.5, "sum",
                           lambda v, c: v * 0.1 + c, 3, mesh=cpu_mesh(D))
    close(got, want)
    single = p.scatter_gather(init, lambda v, _w: v * 0.5, "sum",
                              lambda v, c: v * 0.1 + c, 3)
    close(single, j.scatter_gather(init, lambda v, _w: v * 0.5, "sum",
                                   lambda v, c: v * 0.1 + c, 3))
    if D == 1:
        equal(got, single)


def test_adamic_adar_hand_computed():
    j, p = both([(0, 1), (1, 2), (0, 2), (2, 3)])
    aa = p.adamic_adar()
    close(aa, j.adamic_adar(), rtol=SCORE_RTOL)
    assert aa[0] == pytest.approx(1 / np.log(3), rel=1e-5)
    assert aa[3] == pytest.approx(0.0)


def test_adamic_adar_dense_and_sparse_agree():
    e = random_edges(5, 50, 200)
    j, p = both(e, num_vertices=50)
    dense = p.adamic_adar()
    close(dense, j.adamic_adar(), rtol=SCORE_RTOL)
    adj = {}
    for s_, d in e.tolist():
        if s_ != d:
            adj.setdefault(s_, set()).add(d)
            adj.setdefault(d, set()).add(s_)
    sparse = []
    for s_, d in e.tolist():
        commons = adj.get(s_, set()) & adj.get(d, set())
        sparse.append(sum(1.0 / np.log(len(adj[w]))
                          for w in commons if len(adj[w]) > 1))
    np.testing.assert_allclose(dense, sparse, rtol=1e-4, atol=1e-5)


def test_summarize_contracts_by_label():
    j, p = both([(0, 1), (0, 2), (1, 3), (2, 3), (3, 2)])
    labels_in = np.asarray([10, 10, 20, 20])
    summary, labels, sizes = p.summarize(labels_in)
    js, jl, jsz = j.summarize(labels_in)
    equal(labels, jl)
    equal(sizes, jsz)
    assert edge_map(summary) == edge_map(js) \
        == {(0, 0): 1.0, (0, 1): 2.0, (1, 1): 2.0}
    assert summary.device == p.device


def test_bipartite_projections():
    j, p = both([(0, 3), (1, 3), (1, 4), (2, 4)], num_vertices=5)
    left = p.bipartite_projection(left_size=3, onto_left=True)
    assert edge_map(left) == edge_map(j.bipartite_projection(3, True)) \
        == {(0, 1): 1.0, (1, 2): 1.0}
    right = p.bipartite_projection(left_size=3, onto_left=False)
    assert edge_map(right) == edge_map(j.bipartite_projection(3, False)) \
        == {(0, 1): 1.0}
    assert right.n == 2


def test_vertex_metrics():
    j, p = both([(0, 1), (1, 2)], num_vertices=4)
    m = p.vertex_metrics()
    assert m == j.vertex_metrics()
    assert m["vertices_with_edges"] == 3 and m["max_degree"] == 2


def test_similarity_sparse_branch_matches_dense():
    e = random_edges(9, 50, 200)
    small = Graph.from_edges(e, num_vertices=50, device="cpu")
    big = Graph.from_edges(e, num_vertices=5000, device="cpu")
    jbig = JaxGraph.from_edges(e, num_vertices=5000)
    equal(big.adamic_adar(), jbig.adamic_adar())
    equal(big.jaccard_similarity(), jbig.jaccard_similarity())
    np.testing.assert_allclose(big.adamic_adar(), small.adamic_adar(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(big.jaccard_similarity(),
                               small.jaccard_similarity(),
                               rtol=1e-5, atol=1e-6)


def test_bipartite_dense_and_sparse_paths_agree():
    rng = np.random.default_rng(11)
    left, right, m = 30, 12, 150
    e = np.stack([rng.integers(0, left, m),
                  left + rng.integers(0, right, m)], 1)
    dense = Graph.from_edges(e, num_vertices=left + right, device="cpu")
    sparse = Graph.from_edges(e, num_vertices=left + 5000, device="cpu")
    jdense = JaxGraph.from_edges(e, num_vertices=left + right)
    for onto in (True, False):
        a = dense.bipartite_projection(left, onto_left=onto)
        b = sparse.bipartite_projection(left, onto_left=onto)
        assert edge_map(a) == edge_map(b) \
            == edge_map(jdense.bipartite_projection(left, onto_left=onto))


def test_empty_projection_has_typed_weights():
    j, p = both([(0, 2), (1, 3)], num_vertices=4 + 5000)
    proj = p.bipartite_projection(left_size=2)
    assert proj.num_edges == j.bipartite_projection(left_size=2).num_edges \
        == 0
    assert proj.weights is not None and proj.weights.shape == (0,)
    assert proj.weights.dtype == torch.float32


def test_all_pairs_distances_and_eccentricity():
    j, p = both([(0, 1), (1, 2), (2, 3)], num_vertices=5)
    d = p.all_pairs_distances()
    equal(d, j.all_pairs_distances())
    assert d[0].tolist() == [0, 1, 2, 3, -1]
    assert d[4].tolist() == [-1, -1, -1, -1, 0]
    equal(p.eccentricity(), j.eccentricity())
    assert p.eccentricity().tolist() == [3, 2, 2, 3, 0]
    assert p.diameter_radius() == j.diameter_radius() \
        == {"diameter": 3, "radius": 2}
    dd = p.all_pairs_distances(directed=True)
    equal(dd, j.all_pairs_distances(directed=True))
    assert dd[0, 3] == 3 and dd[3, 0] == -1


def test_closeness_centrality():
    j, p = both([(0, 1), (0, 2), (0, 3), (0, 4)], num_vertices=5)
    c = p.closeness_centrality()
    equal(c, j.closeness_centrality())
    assert c[0] == max(c) and c[0] == pytest.approx(1.0)
    j2, p2 = both([(0, 1), (2, 3)], num_vertices=4)
    c2 = p2.closeness_centrality()
    equal(c2, j2.closeness_centrality())
    assert np.allclose(c2, c2[0]) and 0 < c2[0] < 1.0


@pytest.mark.parametrize("D", MESH_SIZES)
def test_all_pairs_on_mesh(D):
    import jax
    from jax.sharding import Mesh

    jmesh = Mesh(np.array(jax.devices()[:4]), ("d",))
    j, p = both([(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)], num_vertices=6)
    d = p.all_pairs_distances(mesh=cpu_mesh(D))
    equal(d, j.all_pairs_distances(mesh=jmesh))
    assert d[0].tolist() == [0, 1, 2, 3, 4, 5]
    equal(p.eccentricity(mesh=cpu_mesh(D)), j.eccentricity(mesh=jmesh))


def test_diameter_ignores_self_loops_and_shares_distances():
    j, p = both([(0, 1), (2, 2)], num_vertices=3)
    assert p.diameter_radius() == j.diameter_radius() \
        == {"diameter": 1, "radius": 1}
    j2, p2 = both([(0, 1), (1, 2)], num_vertices=3)
    d = p2.all_pairs_distances()
    equal(p2.eccentricity(distances=d), j2.eccentricity(distances=d))
    assert p2.diameter_radius(distances=d) == {"diameter": 2, "radius": 1}
    c = p2.closeness_centrality(distances=d)
    equal(c, j2.closeness_centrality(distances=d))
    assert c[1] == max(c)


# ---------------------------------------------------------------------------
# the port's own: the combine, the mesh at D = 1, larger random graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_segment_combine_equals_jax(kind, dtype):
    """Empty segments hold JAX's identities (``iinfo`` bounds, +-inf), sums
    fold in edge order, and -0.0/+0.0 and NaN reduce as XLA's do."""
    import jax

    rng = np.random.default_rng(21)
    n, e = 50, 400
    dst = rng.integers(0, n - 10, e).astype(np.int32)   # 10 empty segments
    if dtype == "float32":
        msgs = (rng.standard_normal((e,)) * 1e3).astype(np.float32)
        msgs[::7] = 0.0
        msgs[3::7] = -0.0
        msgs[5] = np.nan
    else:
        msgs = rng.integers(-1000, 1000, e).astype(np.int32)
    seg = {"sum": jax.ops.segment_sum, "min": jax.ops.segment_min,
           "max": jax.ops.segment_max}[kind]
    want = np.asarray(seg(jnp.asarray(msgs), jnp.asarray(dst), n))
    got = pgraph.segment_combine(torch.from_numpy(msgs),
                                 torch.from_numpy(dst), n, kind).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    # bit for bit where not NaN: the sign of every zero too
    np.testing.assert_array_equal(got[ok].view(np.int32),
                                  want[ok].view(np.int32))


def test_segment_combine_vector_messages():
    """``[E, k]`` messages combine per column, as JAX's segment ops."""
    import jax

    rng = np.random.default_rng(22)
    msgs = rng.random((300, 4)).astype(np.float32)
    dst = rng.integers(0, 40, 300).astype(np.int32)
    for kind, seg in (("sum", jax.ops.segment_sum),
                      ("min", jax.ops.segment_min)):
        equal(pgraph.segment_combine(torch.from_numpy(msgs),
                                     torch.from_numpy(dst), 45, kind).numpy(),
              np.asarray(seg(jnp.asarray(msgs), jnp.asarray(dst), 45)))


@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_mesh_of_one_equals_single_device_bit_for_bit(combine):
    rng = np.random.default_rng(31)
    n = 120
    p = Graph.from_edges(random_edges(31, n, 900), num_vertices=n,
                         weights=rng.random(900).astype(np.float32),
                         device="cpu")
    init = rng.random(n).astype(np.float32)

    def msg(v, w):
        return v * w

    def update(v, c):
        if combine == "sum":
            return 0.5 * v + c
        return torch.minimum(v, c) if combine == "min" else \
            torch.maximum(v, c)

    single = p.scatter_gather(init, msg, combine, update, 6)
    equal(p.scatter_gather(init, msg, combine, update, 6, mesh=cpu_mesh(1)),
          single)


def test_larger_random_graph_every_algorithm():
    """A 400-vertex random graph: every order-free algorithm exactly,
    PageRank and HITS to ``RANK_RTOL``, against JAX."""
    n = 400
    rng = np.random.default_rng(41)
    e = random_edges(41, n, 3000)
    w = rng.random(3000).astype(np.float32)
    j, p = both(e, num_vertices=n, weights=w)
    equal(p.connected_components(), j.connected_components())
    equal(p.bfs_levels([0, 7]), j.bfs_levels([0, 7]))
    equal(p.bfs_levels(3, directed=True), j.bfs_levels(3, directed=True))
    equal(p.sssp(5), j.sssp(5))
    labels = rng.integers(0, 50, n)
    equal(p.label_propagation(labels), j.label_propagation(labels))
    equal(p.all_pairs_distances(), j.all_pairs_distances())
    equal(p.jaccard_similarity(), j.jaccard_similarity())
    close(p.pagerank(num_iterations=20), j.pagerank(num_iterations=20))
    for a, b in zip(p.hits(), j.hits()):
        close(a, b)


def test_tf32_setting_is_restored():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.set_float32_matmul_precision("medium")
    try:
        Graph.from_edges([(0, 1), (1, 2)], device="cpu").jaccard_similarity()
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])


def test_graph_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Graph.from_edges([(0, 1)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Graph(2, [0], [1])
