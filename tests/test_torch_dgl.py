"""The port's DGL graph functions (``mx.nd.contrib``) against the JAX
package's on the CPU, on one random CSR graph: ``dgl_subgraph`` (with
and without the edge mapping), ``edge_id``, ``dgl_adjacency`` and
``dgl_graph_compact`` equal; the two neighbour samplers, whose numpy
seed comes from another generator than the JAX package's, checked by
structure (each sampled edge is in the graph, at most ``num_neighbor``
picks a vertex, the seeds at hop 0 and every other vertex one hop past
a neighbour, the count in the last slot) and repeated bit for bit under
one ``mx.random.seed``."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch.ndarray import sparse as sp

N = 30


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


def _graph(seed=0, density=0.15):
    rs = np.random.RandomState(seed)
    adj = (rs.rand(N, N) < density) & ~np.eye(N, dtype=bool)
    rows, cols = np.nonzero(adj)
    eids = np.arange(1, len(rows) + 1, dtype=np.float32)   # edge ids
    indptr = np.concatenate([[0], np.cumsum(adj.sum(1))]).astype(np.int64)
    return eids, cols.astype(np.int64), indptr


def _both(seed=0):
    data, idx, ptr = _graph(seed)
    return (sp.csr_matrix((data, idx, ptr), shape=(N, N)),
            jsp.csr_matrix((data, idx, ptr), shape=(N, N)))


def _csr_eq(p, j):
    assert p.shape == j.shape and p.stype == "csr"
    for part in ("indices", "indptr"):
        np.testing.assert_array_equal(
            getattr(p, part).asnumpy().astype(np.int64),
            getattr(j, part).asnumpy().astype(np.int64))
    np.testing.assert_array_equal(p.data.asnumpy(), j.data.asnumpy())
    np.testing.assert_array_equal(p.asnumpy(), j.asnumpy())


@pytest.mark.parametrize("mapping", [False, True])
def test_subgraph_matches_jax(mapping):
    g, jg = _both()
    vids = [np.array([0, 3, 5, 8, 13, 21], np.int64),
            np.arange(10, 25, dtype=np.int64)]
    got = mx.nd.contrib.dgl_subgraph(g, *[mx.nd.array(v) for v in vids],
                                     return_mapping=mapping)
    want = jmx.nd.contrib.dgl_subgraph(jg, *[jmx.nd.array(v) for v in vids],
                                       return_mapping=mapping)
    assert len(got) == len(want) == (4 if mapping else 2)
    for p, j in zip(got, want):
        _csr_eq(p, j)


def test_edge_id_and_adjacency_match_jax():
    g, jg = _both(1)
    rs = np.random.RandomState(1)
    u, v = rs.randint(0, N, 40), rs.randint(0, N, 40)
    got = mx.nd.contrib.edge_id(g, mx.nd.array(u), mx.nd.array(v))
    want = jmx.nd.contrib.edge_id(jg, jmx.nd.array(u), jmx.nd.array(v))
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert (got.asnumpy() == -1).any() and (got.asnumpy() > 0).any()
    _csr_eq(mx.nd.contrib.dgl_adjacency(g),
            jmx.nd.contrib.dgl_adjacency(jg))


def _structure(g_parts, seeds, out_verts, sub, layer, num_hops,
               num_neighbor, max_v):
    data, idx, ptr = g_parts
    verts = out_verts.asnumpy().astype(np.int64)
    n = int(verts[-1])
    assert 0 < n <= max_v and (verts[n:-1] == -1).all()
    v = verts[:n]
    assert (np.diff(v) > 0).all()
    sub_ptr = sub.indptr.asnumpy().astype(np.int64)
    sub_idx = sub.indices.asnumpy().astype(np.int64)
    sub_val = sub.data.asnumpy()
    lay = layer.asnumpy().astype(np.int64)
    assert (lay[n:] == -1).all()
    assert set(v[lay[:n] == 0]) == set(int(s) for s in seeds)
    assert lay[:n].max() <= num_hops
    for i, u in enumerate(v):
        lo, hi = sub_ptr[i], sub_ptr[i + 1]
        assert hi - lo <= num_neighbor
        for c, val in zip(sub_idx[lo:hi], sub_val[lo:hi]):
            dst = v[c]
            row = slice(ptr[u], ptr[u + 1])
            hit = np.nonzero(idx[row] == dst)[0]
            assert len(hit) == 1 and data[row][hit[0]] == val
    for i, u in enumerate(v):   # each vertex past hop 0 has a neighbour
        if lay[i] > 0:          # sampled one hop before it
            preds = [w for w in range(n) if lay[w] == lay[i] - 1
                     and u in idx[ptr[v[w]]:ptr[v[w] + 1]]]
            assert preds, (u, lay[i])
    return n


@pytest.mark.parametrize("weighted", [False, True])
def test_samplers_structure_and_repeat_under_one_seed(weighted):
    g, _ = _both(2)
    parts = _graph(2)
    seeds = [np.array([0, 4], np.int64), np.array([7, 11, 19], np.int64)]
    kw = dict(num_hops=2, num_neighbor=3, max_num_vertices=15)
    prob = np.random.RandomState(3).rand(N).astype(np.float32)
    prob[::5] = 0.0

    def run():
        args = [mx.nd.array(s) for s in seeds]
        if weighted:
            return mx.nd.contrib.dgl_csr_neighbor_non_uniform_sample(
                g, mx.nd.array(prob), *args, **kw)
        return mx.nd.contrib.dgl_csr_neighbor_uniform_sample(g, *args, **kw)

    mx.random.seed(7)
    first = run()
    second = run()
    mx.random.seed(7)
    again = run()
    k = len(seeds)
    assert len(first) == (4 if weighted else 3) * k
    subs = first[(2 if weighted else 1) * k:][:k]
    layers = first[-k:]
    for s, verts, sub, lay in zip(seeds, first[:k], subs, layers):
        n = _structure(parts, s, verts, sub, lay, kw["num_hops"],
                       kw["num_neighbor"], kw["max_num_vertices"])
        assert sub.shape == (15, 15) and n <= 15
    if weighted:
        for verts, p in zip(first[:k], first[k:2 * k]):
            v = verts.asnumpy().astype(np.int64)
            n = int(v[-1])
            np.testing.assert_array_equal(p.asnumpy()[:n], prob[v[:n]])
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert any(not np.array_equal(a.asnumpy(), b.asnumpy())
               for a, b in zip(first, second))


@pytest.mark.parametrize("mapping", [False, True])
def test_graph_compact_matches_jax(mapping):
    g, jg = _both(4)
    mx.random.seed(1)
    samp = mx.nd.contrib.dgl_csr_neighbor_uniform_sample(
        g, mx.nd.array(np.array([2, 9], np.int64)), num_hops=1,
        num_neighbor=4, max_num_vertices=12)
    verts, sub = samp[0], samp[1]
    size = int(verts.asnumpy()[-1])
    parts = (sub.data.asnumpy(), sub.indices.asnumpy(),
             sub.indptr.asnumpy())
    jsub = jsp.csr_matrix(parts, shape=sub.shape)
    graphs, jgraphs = [sub], [jsub]
    if mapping:
        graphs.append(sp.csr_matrix(parts, shape=sub.shape))
        jgraphs.append(jsp.csr_matrix(parts, shape=sub.shape))
    got = mx.nd.contrib.dgl_graph_compact(*graphs, return_mapping=mapping,
                                          graph_sizes=(size,))
    want = jmx.nd.contrib.dgl_graph_compact(*jgraphs,
                                            return_mapping=mapping,
                                            graph_sizes=(size,))
    assert len(got) == len(want)
    for p, j in zip(got, want):
        _csr_eq(p, j)
    with pytest.raises(ValueError, match="graph_sizes"):
        mx.nd.contrib.dgl_graph_compact(sub, graph_sizes=(1, 2))
