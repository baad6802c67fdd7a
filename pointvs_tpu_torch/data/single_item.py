"""One graph as a batch of one, for scoring and attribution (counterpart
of ``pointvs_tpu/data/single_item.py``)."""
from __future__ import annotations

import numpy as np

from pointvs_tpu_torch.data.buckets import GraphBatch, GraphSample, \
    pad_graphs_to_batch


def get_single_graph_for_inference(sample: GraphSample, n_pad=None,
                                   e_pad=None) -> GraphBatch:
    """``sample`` padded into a one-slot ``GraphBatch`` (to ``n_pad`` /
    ``e_pad`` where given, else to the smallest buckets that fit)."""
    return pad_graphs_to_batch([sample], num_graphs=1, n_pad=n_pad,
                               e_pad=e_pad)


def graph_batch_from_arrays(node_feats, coords, senders, receivers,
                            edge_attr, y=None, n_pad=None,
                            e_pad=None) -> GraphBatch:
    """A one-slot ``GraphBatch`` from raw arrays (label 0 unless given)."""
    sample = GraphSample(
        node_feats=np.asarray(node_feats, np.float32),
        coords=np.asarray(coords, np.float32),
        senders=np.asarray(senders, np.int32),
        receivers=np.asarray(receivers, np.int32),
        edge_attr=np.asarray(edge_attr, np.float32),
        y=np.float32(0.0) if y is None else np.asarray(y, np.float32))
    return get_single_graph_for_inference(sample, n_pad=n_pad, e_pad=e_pad)
