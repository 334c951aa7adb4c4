"""Graph library — the Gelly analog, on the card (port of
``flink_tpu/graph_lib/graph.py``).

A graph is (num_vertices, edge src[int32], edge dst[int32], optional f32 edge
weights), held as tensors on the graph's device; algorithms are message
passing, one segment combine of the edges' messages into their destination
vertices a superstep (the scatter-gather / vertex-centric model of Gelly's
``spargel``).  JAX's jitted supersteps are plain functions on tensors here,
with the arithmetic in JAX's order.

The combine (:func:`segment_combine`, the counterpart of JAX's
``_SEGMENT_OPS``):

- ``"sum"`` is the ordered fold: on the CPU ``index_add_``, sequential like
  XLA's CPU scatter; on the card ``ops/scatter.py`` ``ordered_fold``, the
  hand-written ``csrc/scatter_fold.cu``, which adds each vertex's messages in
  edge order, so the card's sums equal the CPU's bit for bit (CUDA's
  ``index_add_`` would add floats with atomics in no fixed order).  Edge
  lists longer than :data:`FOLD_CHUNK_ROWS` fold in edge-order chunks,
  which keeps each vertex's order.
- ``"min"``/``"max"`` are ``index_reduce_`` over dim 0 with the 1-D edge
  index (an ``[E, n]`` message matrix needs no ``[E, n]`` index), over
  rows that start at JAX's identities for empty segments (``iinfo.max`` /
  ``iinfo.min`` for integers, ``+-inf`` for floats).  Floats reduce as
  integer total-order keys of their width, so -0.0 orders below +0.0 as
  in XLA, and a NaN message makes its vertex NaN, as XLA's min/max
  propagate it.

The edge-sharded mesh (``mesh=``, a ``parallel/mesh.py`` ``DeviceMesh``):
the edges are padded to a length D divides (padding rows scatter the
combine's identity to vertex 0, JAX's mask), shard ``d`` lives on
``mesh.devices[d]`` and combines its own messages, and the partials merge
in shard order on ``mesh.devices[0]`` — the ``psum``/``pmin``/``pmax`` of
JAX's ``shard_map``, in a fixed order, so the result does not depend on
thread timing.  One controller drives every shard, as in JAX.

Triangle count, k-core, clustering coefficient, summarization and vertex
metrics are host numpy, as in JAX.  Jaccard, Adamic-Adar and bipartite
projections below :data:`Graph._DENSE_LIMIT` vertices run their dense
products as ``torch.matmul`` on the graph's device, in f32 with TF32 off
(JAX computes them outside any Pallas kernel); above it they take the
sorted-set host paths.  The all-pairs family propagates an ``[n, n]``
int32 matrix through the BFS superstep on the card.

Methods return numpy arrays where JAX's return numpy.  Entry points run on
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.core.functions import canonical_tensor
from flink_tpu_torch.ops.scatter import (TOTAL_ORDER_KEYS, ordered_fold,
                                         total_order)

#: the combine kinds of a superstep
COMBINES = ("sum", "min", "max")

#: most message rows one ``ordered_fold`` call folds: longer edge lists
#: fold in edge-order chunks (the kernel's scratch is ~12 B a row)
FOLD_CHUNK_ROWS = 1 << 27

_INT32_MIN = -(2 ** 31)

def combine_identity(kind: str, dtype: torch.dtype):
    """The combine's identity: what an empty segment holds (JAX's
    ``segment_{sum,min,max}`` fill) and what a padding row carries."""
    if kind == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _extremum_keys(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Float values as total-order keys, NaN as the key that wins ``kind``
    (its inverse is a NaN), so a NaN propagates as in XLA."""
    info = torch.iinfo(TOTAL_ORDER_KEYS[x.dtype])
    nan_key = info.min if kind == "min" else info.max
    return torch.where(torch.isnan(x), nan_key, total_order(x))


def _float_extremum(x: torch.Tensor) -> bool:
    """Whether min/max reduce ``x`` as total-order keys (f32, f64); other
    floats raise."""
    if x.dtype.is_floating_point and x.dtype not in TOTAL_ORDER_KEYS:
        raise TypeError(f"the min/max combine reduces f32, f64 or integer "
                        f"messages, not {x.dtype}")
    return x.dtype in TOTAL_ORDER_KEYS


def segment_combine(msgs: torch.Tensor, dst: torch.Tensor, n: int,
                    kind: str) -> torch.Tensor:
    """JAX's ``jax.ops.segment_{sum,min,max}(msgs, dst, n)``: ``[E, ...]``
    messages combined into ``[n, ...]`` by their destination ``dst[e]``.
    Sums fold in edge order (the CPU's ``index_add_``, the card's
    ``scatter_fold``, bit-equal); min/max reduce with ``index_reduce_``.
    A CUDA sum of a dtype the kernel does not fold raises."""
    if kind not in COMBINES:
        raise ValueError(f"unknown combine {kind!r}: one of {COMBINES}")
    out_shape = (int(n),) + tuple(msgs.shape[1:])
    if kind == "sum":
        out = torch.zeros(out_shape, dtype=msgs.dtype, device=msgs.device)
        if msgs.device.type == "cpu":
            return out.index_add_(0, dst, msgs)
        width = math.prod(msgs.shape[1:])
        if width == 1:
            ids, vals = dst, msgs.reshape(-1)
        else:
            # cell (v, j) of a vector value is v * width + j: each cell's
            # rows stay in edge order
            ids = (dst.to(torch.int64)[:, None] * width
                   + torch.arange(width, device=dst.device)).reshape(-1)
            vals = msgs.reshape(-1)
        plane = out.view(-1)
        for lo in range(0, ids.shape[0], FOLD_CHUNK_ROWS):
            ordered_fold(plane, ids[lo:lo + FOLD_CHUNK_ROWS].contiguous(),
                         vals[lo:lo + FOLD_CHUNK_ROWS].contiguous())
        return out
    ident = combine_identity(kind, msgs.dtype)
    reduce = "amin" if kind == "min" else "amax"
    if _float_extremum(msgs):
        keys = torch.full(out_shape, total_order(
            torch.tensor(ident, dtype=msgs.dtype)).item(),
            dtype=TOTAL_ORDER_KEYS[msgs.dtype], device=msgs.device)
        keys.index_reduce_(0, dst, _extremum_keys(msgs, kind), reduce,
                           include_self=True)
        return total_order(keys).view(msgs.dtype)
    out = torch.full(out_shape, ident, dtype=msgs.dtype, device=msgs.device)
    return out.index_reduce_(0, dst, msgs, reduce, include_self=True)


def merge_partials(a: torch.Tensor, b: torch.Tensor, kind: str
                   ) -> torch.Tensor:
    """Two shards' partial combines merged (the mesh's collective)."""
    if kind == "sum":
        return a + b
    if _float_extremum(a):
        pick = torch.minimum if kind == "min" else torch.maximum
        return total_order(pick(_extremum_keys(a, kind),
                                _extremum_keys(b, kind))).view(a.dtype)
    return torch.minimum(a, b) if kind == "min" else torch.maximum(a, b)


@contextlib.contextmanager
def _f32_matmul():
    """f32 products with TF32 off, whatever the process has set."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An edge column (numpy, a sequence or a tensor) as a ``dtype`` tensor
    on ``device``; 64-bit integers wrap to int32 as ``jnp.asarray`` does."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    arr = np.ascontiguousarray(np.asarray(x).astype(
        np.dtype(str(dtype).replace("torch.", ""))))
    return torch.from_numpy(arr).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``jnp.array_equal``: one host sync."""
    return bool(torch.equal(a, b))


class Graph:
    def __init__(self, num_vertices: int, src, dst, weights=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.n = int(num_vertices)
        self.src = _as_tensor(src, torch.int32, self.device)
        self.dst = _as_tensor(dst, torch.int32, self.device)
        self.weights = (_as_tensor(weights, torch.float32, self.device)
                        if weights is not None else None)
        self._host: dict = {}

    def _np(self, name: str) -> np.ndarray:
        """Host copy of ``src``/``dst``/``weights`` (made once)."""
        if name not in self._host:
            self._host[name] = _numpy(getattr(self, name))
        return self._host[name]

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_edges(edges, num_vertices: Optional[int] = None,
                   weights=None, device: DeviceLike = None) -> "Graph":
        e = np.asarray(edges, np.int64).reshape(-1, 2)
        n = num_vertices if num_vertices is not None else (int(e.max()) + 1
                                                           if e.size else 0)
        return Graph(n, e[:, 0], e[:, 1], weights, device=device)

    @staticmethod
    def from_dataset(ds, src_column: str = "src", dst_column: str = "dst",
                     weight_column: Optional[str] = None,
                     num_vertices: Optional[int] = None,
                     device: DeviceLike = None) -> "Graph":
        """From any object with ``collect_batch()`` (a batch with
        ``column(name)`` and ``len``)."""
        b = ds.collect_batch()
        src = np.asarray(b.column(src_column))
        dst = np.asarray(b.column(dst_column))
        n = num_vertices if num_vertices is not None else (
            int(max(src.max(), dst.max())) + 1 if len(b) else 0)
        w = np.asarray(b.column(weight_column)) if weight_column else None
        return Graph(n, src, dst, w, device=device)

    def as_dataset(self):
        """The edges as a DataSet (``src``, ``dst`` and, when weighted,
        ``weight``: JAX's columns and dtypes), downloaded once, in an
        environment on the graph's device."""
        from flink_tpu_torch.dataset import ExecutionEnvironment
        env = ExecutionEnvironment(device=self.device)
        cols = {"src": self._np("src"), "dst": self._np("dst")}
        if self.weights is not None:
            cols["weight"] = self._np("weights")
        return env.from_columns(cols)

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def undirected(self) -> "Graph":
        """Add reverse edges (``Graph.getUndirected``)."""
        return Graph(self.n,
                     torch.cat([self.src, self.dst]),
                     torch.cat([self.dst, self.src]),
                     None if self.weights is None
                     else torch.cat([self.weights, self.weights]),
                     device=self.device)

    # -- degrees -------------------------------------------------------------
    def out_degrees(self) -> np.ndarray:
        return _numpy(segment_combine(
            torch.ones_like(self.src), self.src, self.n, "sum"))

    def in_degrees(self) -> np.ndarray:
        return _numpy(segment_combine(
            torch.ones_like(self.dst), self.dst, self.n, "sum"))

    # -- generic scatter-gather (vertex-centric supersteps) ------------------
    def scatter_gather(self, initial_values, message_fn: Callable,
                       combine: str, update_fn: Callable,
                       max_supersteps: int,
                       converged: Optional[Callable] = None,
                       mesh=None) -> np.ndarray:
        """Vertex-centric iteration (``ScatterGatherIteration`` analog).

        Per superstep: ``msgs = message_fn(values[src], weights)``
        combined into dst with ``combine`` (sum/min/max), then
        ``values' = update_fn(values, combined)``; ``message_fn`` and
        ``update_fn`` take and return tensors.  Stops at
        ``max_supersteps`` or when ``converged(old, new)`` is True (one
        host sync a superstep, as JAX's ``bool(...)``).

        ``mesh``: a ``DeviceMesh`` — the edges shard over its positions
        (the natural cut for message passing), vertex values replicate;
        each shard combines its messages and the partials merge in shard
        order on ``mesh.devices[0]``."""
        if combine not in COMBINES:
            raise ValueError(f"unknown combine {combine!r}: one of "
                             f"{COMBINES}")
        if mesh is None:
            def superstep(values):
                msgs = message_fn(values[self.src], self.weights)
                combined = segment_combine(msgs, self.dst, self.n, combine)
                return update_fn(values, combined)
        else:
            superstep = self._mesh_superstep(mesh, message_fn, combine,
                                             update_fn)
        dev = self.device if mesh is None else mesh.devices[0]
        values = canonical_tensor(initial_values).to(dev)
        for _ in range(max_supersteps):
            new = superstep(values)
            if converged is not None and bool(converged(values, new)):
                values = new
                break
            values = new
        return _numpy(values)

    def _mesh_superstep(self, mesh, message_fn: Callable, combine: str,
                        update_fn: Callable):
        """Edge-sharded superstep: pad the edges to a length D divides,
        place shard ``d`` on ``mesh.devices[d]``, combine each shard's
        messages there and merge the partials in shard order."""
        D = mesh.size
        E = self.num_edges
        Ep = -(-max(E, 1) // D) * D
        per = Ep // D
        pad = Ep - E
        # padding rows scatter the combine's identity to vertex 0
        zeros = torch.zeros(pad, dtype=torch.int32, device=self.device)
        src_p = torch.cat([self.src, zeros])
        dst_p = torch.cat([self.dst, zeros])
        w = self.weights
        if w is not None:
            w = torch.cat([w, torch.zeros(pad, dtype=w.dtype,
                                          device=self.device)])
        valid = torch.cat([torch.ones(E, dtype=torch.bool,
                                      device=self.device),
                           torch.zeros(pad, dtype=torch.bool,
                                       device=self.device)])
        shards = []
        for d, dev in enumerate(mesh.devices):
            sl = slice(d * per, (d + 1) * per)
            shards.append((dev, src_p[sl].to(dev), dst_p[sl].to(dev),
                           valid[sl].to(dev),
                           None if w is None else w[sl].to(dev)))
        n = self.n
        home = mesh.devices[0]

        def superstep(values):
            combined = None
            for dev, src_l, dst_l, valid_l, w_l in shards:
                vals = values.to(dev)
                msgs = message_fn(vals[src_l], w_l)
                # the edge mask broadcasts over trailing value dims, so
                # vector values behave as on the single-device path
                mask = valid_l.reshape(valid_l.shape + (1,) * (msgs.ndim - 1))
                msgs = torch.where(mask, msgs, torch.tensor(
                    combine_identity(combine, msgs.dtype), dtype=msgs.dtype,
                    device=dev))
                part = segment_combine(msgs, dst_l, n, combine).to(home)
                combined = part if combined is None else merge_partials(
                    combined, part, combine)
            return update_fn(values, combined)

        return superstep

    # -- algorithms ----------------------------------------------------------
    def pagerank(self, damping: float = 0.85, num_iterations: int = 30,
                 tol: float = 0.0, mesh=None) -> np.ndarray:
        """Power iteration with dangling-mass redistribution (``PageRank``):
        ``(1 - d)/n + d * (spread + dangling_mass/n)`` a superstep, in f32.

        ``mesh``: edge-sharded — per-edge contributions carry 1/out_degree
        as edge weights, each shard sums its messages, the partials merge,
        and the dangling-mass/teleport update runs on the rank vector."""
        n = self.n
        home = self.device if mesh is None else mesh.devices[0]
        out_deg = torch.from_numpy(
            self.out_degrees().astype(np.float32)).to(home)
        dangling = out_deg == 0
        safe_deg = torch.where(dangling, 1.0, out_deg)
        if mesh is not None:
            # JAX's numpy 1/deg a vertex, gathered an edge (f32 division,
            # the same bits), made on the device
            inv_deg_e = (torch.ones_like(safe_deg) / safe_deg)[
                self.src.to(home)]
            g = Graph(n, self.src, self.dst, inv_deg_e, device=self.device)

            def msg(vals, w):
                return vals * w

            def update(ranks, spread):
                dm = torch.sum(torch.where(dangling, ranks, 0.0))
                return (1.0 - damping) / n + damping * (spread + dm / n)

            conv = ((lambda a, b: bool(torch.abs(b - a).sum() < tol))
                    if tol else None)
            return g.scatter_gather(
                torch.full((n,), 1.0 / n, dtype=torch.float32), msg, "sum",
                update, num_iterations, conv, mesh=mesh)

        def step(ranks):
            contrib = ranks / safe_deg
            spread = segment_combine(contrib[self.src], self.dst, n, "sum")
            dangling_mass = torch.sum(torch.where(dangling, ranks, 0.0))
            return ((1.0 - damping) / n
                    + damping * (spread + dangling_mass / n))

        ranks = torch.full((n,), 1.0 / n, dtype=torch.float32, device=home)
        for _ in range(num_iterations):
            new = step(ranks)
            if tol and float(torch.abs(new - ranks).sum()) < tol:
                ranks = new
                break
            ranks = new
        return _numpy(ranks)

    def connected_components(self, max_supersteps: int = 0) -> np.ndarray:
        """Min-label propagation over the undirected graph
        (``ConnectedComponents`` delta-iteration analog): each vertex ends
        with the least vertex id of its component."""
        g = self.undirected()
        steps = max_supersteps or self.n

        def msg(vals, _w):
            return vals

        def update(vals, combined):
            return torch.minimum(vals, combined)

        return g.scatter_gather(
            torch.arange(self.n, dtype=torch.int32), msg, "min", update,
            steps, converged=_equal)

    def sssp(self, source: int, num_iterations: int = 0) -> np.ndarray:
        """Single-source shortest paths (``SingleSourceShortestPaths``):
        Bellman-Ford relaxation, one min combine a superstep."""
        w = (self.weights if self.weights is not None
             else torch.ones_like(self.src, dtype=torch.float32))
        dist0 = torch.full((self.n,), float("inf"), dtype=torch.float32)
        dist0[source] = 0.0
        steps = num_iterations or self.n

        def message_fn(src_vals, _weights):
            return src_vals + w

        def update(vals, combined):
            return torch.minimum(vals, combined)

        return self.scatter_gather(dist0, message_fn, "min", update, steps,
                                   converged=_equal)

    def triangle_count(self) -> int:
        """Total triangles (``TriangleEnumerator`` analog): dense adjacency
        trace(A^3)/6 for small graphs, neighbor-set intersection otherwise
        (host numpy, as in JAX)."""
        n = self.n
        src_np, dst_np = self._np("src"), self._np("dst")
        if n <= 2048:
            # float64 on the host: an f32 trace loses exactness past 2^24
            # triangles; counts must be exact
            a = np.zeros((n, n), np.float64)
            a[src_np, dst_np] = 1.0
            a[dst_np, src_np] = 1.0
            np.fill_diagonal(a, 0.0)  # drop self loops
            t = np.trace(a @ a @ a)
            return int(round(t / 6.0))
        adj = {}
        for s, d in zip(src_np.tolist(), dst_np.tolist()):
            if s == d:
                continue
            adj.setdefault(s, set()).add(d)
            adj.setdefault(d, set()).add(s)
        count = 0
        for v, nbrs in adj.items():
            for u in nbrs:
                if u > v:
                    count += len(nbrs & adj.get(u, set())
                                 & {x for x in adj.get(u, set()) if x > u})
        return count

    def k_core(self, k: int, max_iterations: int = 0) -> np.ndarray:
        """bool[n] membership in the k-core (``KCore`` analog): iteratively
        peel vertices with degree < k — vectorized per round.  Degree is
        over DISTINCT neighbors (duplicate and already-bidirectional edge
        lists dedup first, matching triangle_count/clustering semantics)."""
        src0, dst0 = self._np("src"), self._np("dst")
        keep = src0 != dst0
        lo = np.minimum(src0[keep], dst0[keep]).astype(np.int64)
        hi = np.maximum(src0[keep], dst0[keep]).astype(np.int64)
        uniq = np.unique(lo * np.int64(self.n) + hi)
        src = np.concatenate([uniq // self.n, uniq % self.n]).astype(np.int64)
        dst = np.concatenate([uniq % self.n, uniq // self.n]).astype(np.int64)
        alive = np.ones(self.n, bool)
        limit = max_iterations or self.n
        for _ in range(limit):
            live_edge = alive[src] & alive[dst]
            deg = np.bincount(dst[live_edge], minlength=self.n)
            nxt = alive & (deg >= k)
            if (nxt == alive).all():
                break
            alive = nxt
        return alive

    def clustering_coefficient(self) -> np.ndarray:
        """float[n] local clustering coefficient (``LocalClusteringCoefficient``
        analog): triangles through v / (deg(v) choose 2)."""
        src0, dst0 = self._np("src"), self._np("dst")
        src = np.concatenate([src0, dst0])
        dst = np.concatenate([dst0, src0])
        keep = src != dst
        src, dst = src[keep], dst[keep]
        adj: dict = {}
        for s, d in zip(src.tolist(), dst.tolist()):
            adj.setdefault(s, set()).add(d)
        tri = np.zeros(self.n, np.int64)
        for v, nbrs in adj.items():
            t = 0
            for u in nbrs:
                t += len(nbrs & adj.get(u, set()))
            tri[v] = t // 2
        deg = np.asarray([len(adj.get(v, ())) for v in range(self.n)])
        denom = deg * (deg - 1) / 2
        with np.errstate(divide="ignore", invalid="ignore"):
            cc = np.where(denom > 0, tri / np.maximum(denom, 1), 0.0)
        return cc

    _BFS_INF = np.iinfo(np.int32).max

    def _bfs_propagate(self, init: np.ndarray, directed: bool,
                       max_supersteps: int, mesh=None) -> np.ndarray:
        """Shared BFS superstep (min-combine hop propagation) over any
        init shape — [n] for ``bfs_levels``, [n, n] for the simultaneous
        all-pairs variant; -1 marks unreachable."""
        inf = self._BFS_INF

        def msg(vals, _w):
            return torch.where(vals < inf, vals + 1, inf)

        def update(vals, combined):
            return torch.minimum(vals, combined).to(torch.int32)

        g = self if directed else self.undirected()
        out = g.scatter_gather(
            init, msg, "min", update, max_supersteps or self.n,
            converged=_equal, mesh=mesh)
        return np.where(out >= inf, -1, out).astype(np.int32)

    def bfs_levels(self, sources, max_supersteps: int = 0,
                   directed: bool = False, mesh=None) -> np.ndarray:
        """int32[n] hop distance from the nearest source (multi-source BFS);
        unreachable = -1.  Default treats edges as undirected;
        ``directed=True`` follows edge direction only (matching ``sssp``,
        which always runs on the directed edges)."""
        srcs = np.atleast_1d(np.asarray(sources, np.int64))
        init = np.full(self.n, self._BFS_INF, np.int32)
        init[srcs] = 0
        return self._bfs_propagate(init, directed, max_supersteps, mesh)

    def label_propagation(self, initial_labels,
                          num_iterations: int = 10) -> np.ndarray:
        """Community detection by iterated max-label adoption
        (``LabelPropagation`` analog, deterministic max tie-break)."""
        g = self.undirected()

        def msg(vals, _w):
            return vals

        def update(vals, combined):
            # adopt the max neighbor label (0 in-degree keeps its own)
            has_nb = combined > _INT32_MIN
            return torch.where(has_nb, torch.maximum(vals, combined), vals)

        labels = canonical_tensor(np.asarray(initial_labels)).to(torch.int32)
        return g.scatter_gather(labels, msg, "max", update, num_iterations,
                                converged=_equal)

    def hits(self, num_iterations: int = 20
             ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (hubs, authorities), L2-normalized (``HITS`` analog): one
        step does both sums a superstep."""
        n = self.n

        def step(hub):
            auth = segment_combine(hub[self.src], self.dst, n, "sum")
            auth = auth / torch.clamp(torch.linalg.norm(auth), min=1e-12)
            hub2 = segment_combine(auth[self.dst], self.src, n, "sum")
            return (hub2 / torch.clamp(torch.linalg.norm(hub2), min=1e-12),
                    auth)

        root = torch.sqrt(torch.tensor(float(max(n, 1)), dtype=torch.float32))
        hub = (torch.ones(n, dtype=torch.float32) / root).to(self.device)
        auth = hub
        for _ in range(num_iterations):
            hub, auth = step(hub)
        return _numpy(hub), _numpy(auth)

    # one source of truth for the similarity kernels' neighborhood views:
    # the dense/sparse split, symmetrization, and self-loop policy must
    # stay identical across jaccard_similarity / adamic_adar
    _DENSE_LIMIT = 4096

    def _dense_undirected_adjacency(self) -> np.ndarray:
        """Symmetric 0/1 adjacency with a zero diagonal (n <= _DENSE_LIMIT)."""
        a = np.zeros((self.n, self.n), np.float32)
        a[self._np("src"), self._np("dst")] = 1.0
        a[self._np("dst"), self._np("src")] = 1.0
        np.fill_diagonal(a, 0.0)
        return a

    def _undirected_neighbor_sets(self) -> dict:
        """vertex -> set of neighbors (self-loops dropped) — the sparse
        twin of :meth:`_dense_undirected_adjacency`."""
        adj: dict = {}
        for s, d in zip(self._np("src").tolist(), self._np("dst").tolist()):
            if s != d:
                adj.setdefault(s, set()).add(d)
                adj.setdefault(d, set()).add(s)
        return adj

    def _matmul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """``a @ b`` of host f32 matrices on the graph's device, in f32."""
        with _f32_matmul():
            return _numpy(torch.matmul(torch.from_numpy(a).to(self.device),
                                       torch.from_numpy(b).to(self.device)))

    def adamic_adar(self) -> np.ndarray:
        """Per-EDGE Adamic-Adar index: sum over common neighbors w of
        ``1 / log(deg(w))`` (``AdamicAdar.java`` in Gelly's similarity
        library).  Dense path: ``A @ diag(1/log deg) @ A.T`` — one f32
        product on the device; sorted-set fallback beyond 4096 vertices."""
        src_np, dst_np = self._np("src"), self._np("dst")
        if self.n <= self._DENSE_LIMIT:
            a = self._dense_undirected_adjacency()
            deg = a.sum(axis=1)
            inv_log = np.where(deg > 1, 1.0 / np.log(np.maximum(deg, 2.0)),
                               0.0).astype(np.float32)
            scores = self._matmul(a * inv_log[None, :],
                                  np.ascontiguousarray(a.T))
            return scores[src_np, dst_np]
        adj = self._undirected_neighbor_sets()
        out = np.zeros(len(src_np), np.float32)
        for i, (s, d) in enumerate(zip(src_np.tolist(), dst_np.tolist())):
            commons = adj.get(s, set()) & adj.get(d, set())
            out[i] = sum(1.0 / np.log(len(adj[w]))
                         for w in commons if len(adj[w]) > 1)
        return out

    def summarize(self, vertex_labels: np.ndarray
                  ) -> Tuple["Graph", np.ndarray, np.ndarray]:
        """Structural summarization (``Summarization.java``): contract
        vertices sharing a label into one summary vertex; summary edges
        are the DISTINCT (src-label, dst-label) pairs weighted by how many
        original edges they group.  Returns ``(summary graph with edge
        counts as weights, label of each summary vertex, original-vertex
        count per summary vertex)``."""
        labels = np.asarray(vertex_labels)
        uniq, inv = np.unique(labels, return_inverse=True)
        group_sizes = np.bincount(inv, minlength=len(uniq))
        s = inv[self._np("src")]
        d = inv[self._np("dst")]
        pair = s.astype(np.int64) * len(uniq) + d
        upair, counts = np.unique(pair, return_counts=True)
        g = Graph(len(uniq), upair // len(uniq), upair % len(uniq),
                  counts.astype(np.float32), device=self.device)
        return g, uniq, group_sizes.astype(np.int64)

    def bipartite_projection(self, left_size: int,
                             onto_left: bool = True) -> "Graph":
        """Bipartite projection (Gelly's ``BipartiteGraph``
        ``projectionTopSimple`` analog): edges run left->right with left
        ids in ``[0, left_size)`` and right ids in ``[left_size, n)``;
        the projection connects two LEFT vertices whenever they share a
        right neighbor (or two right vertices, ``onto_left=False``),
        weighted by the number of shared neighbors.  Self-loops drop."""
        src_np, dst_np = self._np("src"), self._np("dst")
        if onto_left:
            keys, others, size = dst_np - left_size, src_np, left_size
        else:
            keys, others, size = src_np, dst_np - left_size, self.n - left_size
        nkeys = (self.n - left_size) if onto_left else left_size
        if size <= self._DENSE_LIMIT and nkeys <= self._DENSE_LIMIT:
            # shared-neighbor counts = B.T @ B on the biadjacency matrix;
            # the strict upper triangle keeps (u < v) pairs once
            b = np.zeros((nkeys, size), np.float32)
            b[keys, others] = 1.0
            counts = self._matmul(np.ascontiguousarray(b.T), b)
            es, ed = np.nonzero(np.triu(counts, k=1))
            return Graph(size, es.astype(np.int64), ed.astype(np.int64),
                         counts[es, ed].astype(np.float32),
                         device=self.device)
        pairs: dict = {}
        by_key: dict = {}
        for k, v in zip(keys.tolist(), others.tolist()):
            by_key.setdefault(k, []).append(v)
        for members in by_key.values():
            ms = sorted(set(members))
            for i, u in enumerate(ms):
                for v in ms[i + 1:]:
                    pairs[(u, v)] = pairs.get((u, v), 0) + 1
        if not pairs:
            return Graph(size, np.empty(0, np.int64), np.empty(0, np.int64),
                         np.empty(0, np.float32), device=self.device)
        es = np.asarray([p[0] for p in pairs], np.int64)
        ed = np.asarray([p[1] for p in pairs], np.int64)
        w = np.asarray(list(pairs.values()), np.float32)
        return Graph(size, es, ed, w, device=self.device)

    def vertex_metrics(self) -> dict:
        """Aggregate graph metrics (``VertexMetrics.java``): vertex/edge
        counts, average degree, max degree, and the number of vertices
        with at least one edge."""
        deg = self.out_degrees() + self.in_degrees()
        return {
            "vertices": self.n,
            "edges": self.num_edges,
            "average_degree": float(deg.mean()) if self.n else 0.0,
            "max_degree": int(deg.max()) if self.n else 0,
            "vertices_with_edges": int((deg > 0).sum()),
        }

    def all_pairs_distances(self, directed: bool = False,
                            max_supersteps: int = 0,
                            mesh=None) -> np.ndarray:
        """int32[n, n] hop distances (``d[i, j]`` = hops from i to j,
        -1 = unreachable) — ALL sources propagate simultaneously as one
        [n, n] vertex-value matrix through the same scatter-gather
        superstep (one min combine a step instead of n BFS runs).  The
        messages are ``[E, n]``: sized for the analysis-scale graphs the
        eccentricity/closeness family targets."""
        init = np.full((self.n, self.n), self._BFS_INF, np.int32)
        np.fill_diagonal(init, 0)
        out = self._bfs_propagate(init, directed, max_supersteps, mesh)
        # out[i, j] = distance from column-source j; expose row-source
        # orientation d[i, j] = i -> j
        return out.T.copy()

    def eccentricity(self, mesh=None,
                     distances: Optional[np.ndarray] = None) -> np.ndarray:
        """int32[n] eccentricity: each vertex's maximum hop distance to
        any REACHABLE vertex over the undirected graph (isolated
        vertices: 0).  Pass a precomputed ``all_pairs_distances()`` matrix
        to share one BFS across the eccentricity/closeness/diameter
        family."""
        d = (distances if distances is not None
             else self.all_pairs_distances(mesh=mesh))
        masked = np.where(d >= 0, d, 0)
        return masked.max(axis=1).astype(np.int32)

    def closeness_centrality(self, mesh=None,
                             distances: Optional[np.ndarray] = None
                             ) -> np.ndarray:
        """float32[n] closeness with the Wasserman–Faust component
        correction: ``((r-1)/(n-1)) * ((r-1)/sum_d)`` where r = reachable
        vertices (incl. self); isolated vertices score 0."""
        d = (distances if distances is not None
             else self.all_pairs_distances(mesh=mesh))
        reach = (d >= 0).sum(axis=1)                  # includes self (d=0)
        dist_sum = np.where(d > 0, d, 0).sum(axis=1)
        r1 = (reach - 1).astype(np.float64)
        denom = np.maximum(dist_sum, 1)
        frac = np.where(dist_sum > 0, r1 / denom, 0.0)
        scale = r1 / max(self.n - 1, 1)
        return (scale * frac).astype(np.float32)

    def diameter_radius(self, mesh=None,
                        distances: Optional[np.ndarray] = None) -> dict:
        """Graph diameter/radius over the undirected graph's non-isolated
        vertices.  Self-loops do not make a vertex non-isolated."""
        ecc = self.eccentricity(mesh=mesh, distances=distances)
        src_np, dst_np = self._np("src"), self._np("dst")
        real = src_np != dst_np                  # ignore self-loops
        deg = np.zeros(self.n, np.int64)
        np.add.at(deg, src_np[real], 1)
        np.add.at(deg, dst_np[real], 1)
        live = ecc[deg > 0]
        if live.size == 0:
            return {"diameter": 0, "radius": 0}
        return {"diameter": int(live.max()), "radius": int(live.min())}

    def jaccard_similarity(self) -> np.ndarray:
        """Per-EDGE Jaccard index |N(u) ∩ N(v)| / |N(u) ∪ N(v)| over the
        undirected neighborhood (``JaccardIndex`` analog).  Dense
        adjacency product on the device for n <= 4096 (exact: integer
        counts in f32); sorted set intersection beyond."""
        src_np, dst_np = self._np("src"), self._np("dst")
        if self.n <= self._DENSE_LIMIT:
            a = self._dense_undirected_adjacency()
            common = self._matmul(a, np.ascontiguousarray(a.T))[src_np,
                                                                dst_np]
            deg = a.sum(axis=1)
            union = deg[src_np] + deg[dst_np] - common
            return np.where(union > 0, common / np.maximum(union, 1.0), 0.0)
        adj = self._undirected_neighbor_sets()
        out = np.zeros(len(src_np), np.float32)
        for i, (s, d) in enumerate(zip(src_np.tolist(), dst_np.tolist())):
            ns, nd = adj.get(s, set()), adj.get(d, set())
            inter = len(ns & nd)
            union = len(ns | nd)
            out[i] = inter / union if union else 0.0
        return out
