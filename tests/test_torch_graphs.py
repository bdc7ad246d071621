"""Port parity: the host-side data layer of ``repro_torch`` gives the
same bytes as ``repro`` — synthetic graph, semantic graphs, block CSR and
the multigraph work-unit tables — and the same similarity schedule."""
import numpy as np
import pytest

import repro.core.fusion as jfusion
import repro.core.scheduling as jsched
import repro.graphs as jgraphs
import repro_torch.core.fusion as tfusion
import repro_torch.core.scheduling as tsched
import repro_torch.graphs as tgraphs

DATASETS = ["imdb", "acm"]


def _metapaths(name):
    target, _ = jgraphs.dataset_target(name)
    return [mp for mp in jgraphs.dataset_metapaths(name) if mp[0] == target == mp[-1]]


@pytest.mark.parametrize("name", DATASETS)
def test_synthetic_hetgraph_identical(name):
    jg = jgraphs.synthetic_hetgraph(name, scale=0.05, feat_scale=0.02, seed=0)
    tg = tgraphs.synthetic_hetgraph(name, scale=0.05, feat_scale=0.02, seed=0)
    assert dict(jg.vertex_counts) == dict(tg.vertex_counts)
    for t in jg.features:
        assert jg.features[t].dtype == tg.features[t].dtype
        assert np.array_equal(jg.features[t], tg.features[t])
    assert list(jg.relations) == list(tg.relations)
    for r in jg.relations:
        assert np.array_equal(jg.relations[r].src_ids, tg.relations[r].src_ids)
        assert np.array_equal(jg.relations[r].dst_ids, tg.relations[r].dst_ids)


@pytest.mark.parametrize("name", DATASETS)
def test_semantic_graphs_block_csr_and_unit_tables_identical(name):
    jg = jgraphs.synthetic_hetgraph(name, scale=0.05, feat_scale=0.02, seed=0)
    tg = tgraphs.synthetic_hetgraph(name, scale=0.05, feat_scale=0.02, seed=0)
    jb, tb = [], []
    for i, mp in enumerate(_metapaths(name)):
        jsg = jgraphs.build_semantic_graph(jg, mp, max_edges=2000, seed=i)
        tsg = tgraphs.build_semantic_graph(tg, mp, max_edges=2000, seed=i)
        assert jsg.name == tsg.name and jsg.path_types == tsg.path_types
        assert np.array_equal(jsg.src_ids, tsg.src_ids)
        assert np.array_equal(jsg.dst_ids, tsg.dst_ids)
        jbc = jgraphs.to_block_csr(jsg, block=8)
        tbc = tgraphs.to_block_csr(tsg, block=8)
        assert (jbc.num_dst_pad, jbc.num_src_pad, jbc.num_edges) == (
            tbc.num_dst_pad, tbc.num_src_pad, tbc.num_edges)
        assert np.array_equal(jbc.col_index, tbc.col_index)
        assert np.array_equal(jbc.masks, tbc.masks)
        jb.append(jfusion.batch_semantic_graph(jsg, block=8, with_edges=False))
        tb.append(tfusion.batch_semantic_graph(tsg, block=8, device="cpu"))
    for ja, ta in zip(jfusion.build_unit_tables(jb), tfusion.build_unit_tables(tb)):
        ja, ta = np.asarray(ja), ta.numpy()
        assert ja.dtype == ta.dtype and np.array_equal(ja, ta)


def test_similarity_schedule_identical():
    jg = jgraphs.synthetic_hetgraph("imdb", scale=0.05, feat_scale=0.02, seed=0)
    sgs = [jgraphs.build_semantic_graph(jg, mp, max_edges=2000) for mp in _metapaths("imdb")]
    sgs += sgs[:2]
    jw = jsched.similarity_matrix(sgs, jg.vertex_counts)
    tw = tsched.similarity_matrix(sgs, jg.vertex_counts)
    assert np.array_equal(jw, tw)
    assert jsched.shortest_hamilton_path(jw) == tsched.shortest_hamilton_path(tw)
