"""The yardstick's arithmetic: the card's peaks, the bytes and operations
of kernels K1 and K2 from their shapes, and the matrix-product FLOPs of
the EGNN that the real graphs need.

Peaks are one NVIDIA H100 SXM's published figures (the data sheet, dense,
at its 700 W limit): 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside
the tensor cores, the rate of the port's float32 products with TF32 off.
A kernel's least time is the larger of its bytes over the bandwidth and
its operations over the float32 rate; bytes count each input read once
and each output written once, and edges count as the kernel's row
offsets give them (the real edges, not the padding).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def k1_work(real: int, n: int, k: int) -> tuple:
    """(bytes, flops) of one K1 launch (``segment_sum_sorted``): the real
    edges' [real, k] rows and the n + 1 row offsets read, the [n, k] sums
    written; one addition per element summed."""
    return 4 * (real * k + (n + 1) + n * k), real * k


def k2_work(real: int, n: int, k: int) -> tuple:
    """(bytes, flops) of one K2 launch (``softmax_aggregate_sorted``): the
    real edges' features [real, k], coordinate terms [real, 3], logit and
    mask, and the row offsets read; [n, k + 6] sums and the [n] maxima
    written; per edge the max, the exponential, the weight and the
    weighted sums, 2k + 12 operations."""
    return (4 * (real * (k + 5) + (n + 1) + n * (k + 7)),
            real * (2 * k + 12))


def egnn_forward_flops(nodes: int, edges: int, graphs: int, k: int,
                       layers: int, dim_input: int = 12,
                       dim_output: int = 1) -> int:
    """Matrix-product FLOPs of one EGNN forward (``reference/egnn.py``)
    over real nodes, edges and graphs: per edge and layer the edge MLP
    ([2k+4] -> k -> k), the coordinate MLP (k -> k -> 1) and the attention
    logit (k -> 1); per node and layer the node MLP (2k -> k -> k); the
    input embedding per node and the head per graph; two FLOPs a
    multiply-add."""
    per_edge = (2 * k + 4) * k + k * k + k * k + k + k
    per_node = 2 * k * k + k * k
    return 2 * (layers * (edges * per_edge + nodes * per_node)
                + nodes * dim_input * k + graphs * k * dim_output)


def egnn_train_flops(nodes: int, edges: int, graphs: int, k: int,
                     layers: int, **kw) -> int:
    """Forward and backward products of a training step: three times the
    forward's (the backward takes two products per forward product);
    recomputation under ``--remat`` is not model work and is not
    counted."""
    return 3 * egnn_forward_flops(nodes, edges, graphs, k, layers, **kw)


def idle_share(obs: dict, kind: str):
    """Percent of the traced window with no device operation running."""
    trace = obs.get('trace')
    if obs['kind'] != kind or not trace or not trace['window_s'] \
            or not trace['busy_s']:
        return None
    return 100.0 * (1.0 - trace['busy_s'] / trace['window_s'])


def kernel_roofline(obs: dict, kind: str, kernel: str):
    """Percent: the recorded launches' least time over the kernel's device
    time in the trace; nothing where the trace and the records disagree on
    the launches."""
    from pvsbench.trace import kernel_seconds
    trace = obs.get('trace')
    if obs['kind'] != kind or not trace or 'shapes' not in trace:
        return None
    shapes = trace['shapes'][kernel]
    seconds, launches = kernel_seconds(trace, kernel)
    if not launches or launches != len(shapes):
        return None
    work = k1_work if kernel == 'k1' else k2_work
    least = sum(least_seconds(*work(*shape)) for shape in shapes)
    return 100.0 * least / seconds


def model_flops_share(obs: dict, kind: str):
    """Percent of the float32 peak that the window's model FLOPs reach."""
    if obs['kind'] != kind or not obs.get('model_flops'):
        return None
    return 100.0 * obs['model_flops'] / obs['window_s'] / F32_FLOPS_PER_S
