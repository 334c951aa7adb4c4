"""The bytes and operations a PageRank job on the Graph500 graph needs,
from its shapes, whatever kernels do the work.  The graph is undirected:
each edge is two arcs.  The out-degrees: each arc's source read (4 B), a
degree written a vertex (4 B); then each superstep reads each arc's
endpoints (2 x 4 B) and reads and writes the rank and degree vectors (a
rank read, a degree read and a rank written: 3 x 4 B a vertex); one add an
arc a superstep.  Other jobs have no model here yet, so their roofline
stays silent."""


def window_work(ctx):
    c = ctx.counters
    if c.get("method") != "pagerank" or not c.get("jobs"):
        return None
    n, arcs = c["vertices"], c["arcs"]
    steps = int(c["kwargs"]["num_iterations"])
    per_job = 4 * arcs + 4 * n + steps * (8 * arcs + 12 * n)
    return c["jobs"] * per_job, c["jobs"] * steps * arcs
