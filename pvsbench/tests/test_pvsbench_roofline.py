"""The byte and FLOP counts of K1, K2 and the EGNN step, against hand
counts at small shapes, and the trace reader on made-up events."""
import torch

from pvsbench import roofline, trace


def test_k1_work_by_hand():
    # 10 real edges of width 3 summed into 4 rows: 30 floats and 5
    # offsets read, 12 sums written; 30 additions.
    assert roofline.k1_work(10, 4, 3) == (4 * (30 + 5 + 12), 30)


def test_k2_work_by_hand():
    # 10 real edges, width 2: features 20, coordinate terms 30, logits
    # 10, mask 10 and 5 offsets read; 4 x (2 + 6) sums and 4 maxima
    # written; 2 * 2 + 12 = 16 operations an edge.
    nbytes, flops = roofline.k2_work(10, 4, 2)
    assert nbytes == 4 * (20 + 30 + 10 + 10 + 5 + 32 + 4)
    assert flops == 160


def test_least_seconds_takes_the_larger_bound():
    assert roofline.least_seconds(3.35e12, 0) == 1.0
    assert roofline.least_seconds(0, 67e12) == 1.0
    assert roofline.least_seconds(3.35e12, 2 * 67e12) == 2.0


def test_egnn_flops_by_hand():
    # k=2, one layer, one graph of 3 nodes and 4 edges, 12 inputs, 1 out.
    # Per edge: edge MLP 8*2 + 2*2, coordinate MLP 2*2 + 2, attention 2.
    # Per node: node MLP 4*2 + 2*2. Embedding 12*2 a node; head 2.
    per_edge = 16 + 4 + 4 + 2 + 2
    per_node = 8 + 4
    want = 2 * (4 * per_edge + 3 * per_node + 3 * 24 + 2)
    assert roofline.egnn_forward_flops(3, 4, 1, 2, 1) == want
    assert roofline.egnn_train_flops(3, 4, 1, 2, 1) == 3 * want


class _Event:
    def __init__(self, name, start, end, cuda):
        self._n, self._s, self._e, self._c = name, start, end, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def is_user_annotation(self):
        return self._n.startswith('pvsbench.')

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)


def test_trace_summary_by_hand():
    events = [_Event(trace.WINDOW_SPAN, 0, 1000, False),
              _Event('pvsbench.train.epoch', 0, 700, False),
              _Event('segment_sum_sorted_kernel', 100, 200, True),
              _Event('gemm', 150, 300, True),
              _Event('gemm', 500, 600, True),
              _Event('outside', 2000, 2100, True),
              _Event('pvsbench.train.epoch', 0, 1000, True)]   # mirrored
    s = trace.summarise(events)
    assert s['window_s'] == 1000 / 1e9
    assert s['busy_s'] == 300 / 1e9
    assert s['by_name']['gemm'] == (250 / 1e9, 2)
    # Gaps [0, 100] and [300, 500] fall in the epoch's span, [600, 1000]
    # (its middle at 800) outside it.
    assert abs(s['gaps']['pvsbench.train.epoch'] - 300 / 1e9) < 1e-15
    assert abs(s['gaps']['outside_benchmark_spans'] - 400 / 1e9) < 1e-15
    assert trace.kernel_seconds(s, 'k1') == (100 / 1e9, 1)
    obs = {'kind': 'train', 'trace': dict(s, shapes={'k1': [(10, 4, 3)]})}
    share = roofline.kernel_roofline(obs, 'train', 'k1')
    want = roofline.least_seconds(*roofline.k1_work(10, 4, 3)) / 1e-7
    assert abs(share - 100 * want) < 1e-9
    obs['trace']['shapes']['k1'].append((1, 1, 1))   # counts disagree
    assert roofline.kernel_roofline(obs, 'train', 'k1') is None
    assert abs(roofline.idle_share(obs, 'train') - 70.0) < 1e-9
