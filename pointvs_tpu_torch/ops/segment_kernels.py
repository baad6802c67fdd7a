"""The two segment kernels of the serving path, with their plain versions.

Counterpart of ``pointvs_tpu/ops/pallas/segment_kernels.py``. Each wrapper
takes its plain PyTorch version for tensors on the CPU and launches its
CUDA kernel (``csrc/segment_kernels.cu``) for tensors on a GPU; it never
falls back from one to the other. Each wrapper counts its launches in
``<wrapper>.launches`` so a run can show that it went through the kernel.

Contract shared by both: ``sorted_ids`` is int32, sorted ascending, and an
id equal to ``num_segments`` marks a padding edge, which is dropped. The
kernels read each row's edge range from ``segment_offsets``: a caller that
launches several times over one id array finds them once and passes them
in (``offsets=``); the wrappers find them only when they are not given.
"""
from __future__ import annotations

import torch

_MODES = ('softmax', 'sigmoid')


def segment_offsets(sorted_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """int32 [num_segments + 1]: ``offsets[n]`` is the first edge whose id
    is >= n, so row n's edges are ``[offsets[n], offsets[n + 1])`` and
    ``offsets[num_segments]`` is the first padding edge.

    The counterpart of the JAX wrappers' window starts (``jnp.searchsorted``
    outside the kernel), for every row. On a GPU each call is counted in
    ``segment_offsets.launches``.
    """
    targets = torch.arange(num_segments + 1, dtype=sorted_ids.dtype,
                           device=sorted_ids.device)
    offsets = torch.searchsorted(sorted_ids.contiguous(), targets,
                                 out_int32=True)
    if sorted_ids.device.type == 'cuda':
        segment_offsets.launches += 1
    return offsets


segment_offsets.launches = 0


def windowed_segment_sum_plain(data: torch.Tensor, sorted_ids: torch.Tensor,
                               num_segments: int) -> torch.Tensor:
    """[E, K] data + ascending ids -> [num_segments, K] per-id sums."""
    out = data.new_zeros((num_segments + 1, data.shape[1]))
    out.index_add_(0, sorted_ids, data)
    return out[:num_segments]


def fused_softmax_aggregate_plain(feat, logits, trans, mask, sorted_ids,
                                  num_segments: int, mode: str = 'softmax'):
    """(out [N, K+6], seg_max [N]) as the kernel computes them.

    out = [sum w*feat (K) | sum mask*trans (3) | 0 | sum w | sum mask] with
    w = exp(logits - seg_max[id]) * mask (softmax; seg_max is the masked
    max of the id's logits, 0 when none is unmasked) or
    w = sigmoid(logits) * mask (sigmoid; seg_max is all zeros).
    """
    if mode not in _MODES:
        raise ValueError(f'mode must be one of {_MODES}, got {mode!r}')
    n = num_segments
    if mode == 'softmax':
        guarded = torch.where(mask > 0, logits, logits.new_tensor(-1e30))
        seg_max = logits.new_full((n + 1,), -1e30).scatter_reduce_(
            0, sorted_ids.long(), guarded, 'amax', include_self=True)[:n]
        seg_max = torch.where(seg_max > -1e29, seg_max,
                              seg_max.new_zeros(()))
        shift = torch.cat([seg_max, seg_max.new_zeros(1)])[sorted_ids]
        w = torch.exp(logits - shift) * mask
    else:
        seg_max = logits.new_zeros(n)
        w = torch.sigmoid(logits) * mask
    packed = torch.cat([feat * w[:, None], trans * mask[:, None],
                        torch.zeros_like(mask)[:, None], w[:, None],
                        mask[:, None]], dim=1)
    return windowed_segment_sum_plain(packed, sorted_ids, n), seg_max


def _check_cuda(name, ids, num_segments, **floats):
    device = ids.device
    if device.type != 'cuda':
        raise ValueError(f'{name}: tensors must all be on one CUDA device '
                         f'(ids on {device})')
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(f'{name}: sorted_ids must be 1-D int32, got '
                         f'{tuple(ids.shape)} {ids.dtype}')
    if not 0 <= num_segments < 2 ** 31 - 1:
        raise ValueError(f'{name}: num_segments {num_segments} out of range')
    for arg, t in floats.items():
        if t.device != device:
            raise ValueError(f'{name}: {arg} on {t.device}, ids on {device}')
        if t.dtype != torch.float32:
            raise ValueError(f'{name}: {arg} must be float32, got {t.dtype}')
        if t.shape[0] != ids.shape[0]:
            raise ValueError(f'{name}: {arg} has {t.shape[0]} rows, ids '
                             f'{ids.shape[0]}')


def _offsets_for(name, ids, num_segments, offsets):
    """The given offsets, checked, or ``segment_offsets`` of the ids."""
    if offsets is None:
        return segment_offsets(ids, num_segments)
    if (offsets.device != ids.device or offsets.dtype != torch.int32
            or tuple(offsets.shape) != (num_segments + 1,)):
        raise ValueError(f'{name}: offsets must be int32 '
                         f'[{num_segments + 1}] on {ids.device}, got '
                         f'{tuple(offsets.shape)} {offsets.dtype} on '
                         f'{offsets.device}')
    return offsets.contiguous()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: cudaError {err}')


def windowed_segment_sum(data: torch.Tensor, sorted_ids: torch.Tensor,
                         num_segments: int,
                         offsets: torch.Tensor | None = None) -> torch.Tensor:
    """[E, K] f32 data + ascending int32 ids -> [num_segments, K] sums.

    CUDA: kernel K1 ``segment_sum_sorted`` over ``offsets`` (found here
    when not given). CPU: the plain version, which ignores ``offsets``.
    """
    if data.device.type == 'cpu' and sorted_ids.device.type == 'cpu':
        return windowed_segment_sum_plain(data, sorted_ids, num_segments)
    if data.dim() != 2:
        raise ValueError(f'data must be [E, K], got {tuple(data.shape)}')
    _check_cuda('segment_sum_sorted', sorted_ids, num_segments, data=data)
    data = data.contiguous()
    k = data.shape[1]
    out = torch.empty((num_segments, k), device=data.device,
                      dtype=torch.float32)
    if num_segments == 0 or k == 0:
        return out
    offsets = _offsets_for('segment_sum_sorted', sorted_ids, num_segments,
                           offsets)
    from pointvs_tpu_torch.ops._build import load
    lib = load('segment_kernels')
    with torch.cuda.device(data.device):
        err = lib.pvs_segment_sum_sorted(
            data.data_ptr(), offsets.data_ptr(), out.data_ptr(), k,
            num_segments, _stream(data.device))
    _raise_on(err, 'segment_sum_sorted')
    windowed_segment_sum.launches += 1
    return out


windowed_segment_sum.launches = 0


def fused_softmax_aggregate(feat, logits, trans, mask, sorted_ids,
                            num_segments: int, mode: str = 'softmax',
                            offsets: torch.Tensor | None = None):
    """Attention-weighted aggregation in one pass (see the plain version
    for the exact outputs). feat [E, K], logits [E], trans [E, 3],
    mask [E], all f32; returns (out [N, K+6], seg_max [N]).

    CUDA: kernel K2 ``softmax_aggregate_sorted`` over ``offsets`` (found
    here when not given). CPU: the plain version, which ignores them.
    """
    if mode not in _MODES:
        raise ValueError(f'mode must be one of {_MODES}, got {mode!r}')
    tensors = (feat, logits, trans, mask, sorted_ids)
    if all(t.device.type == 'cpu' for t in tensors):
        return fused_softmax_aggregate_plain(feat, logits, trans, mask,
                                             sorted_ids, num_segments, mode)
    if (feat.dim() != 2 or logits.dim() != 1 or mask.dim() != 1
            or tuple(trans.shape[1:]) != (3,)):
        raise ValueError('expected feat [E, K], logits [E], trans [E, 3], '
                         'mask [E]')
    _check_cuda('softmax_aggregate_sorted', sorted_ids, num_segments,
                feat=feat, logits=logits, trans=trans, mask=mask)
    feat, logits, trans, mask = (t.contiguous() for t in tensors[:4])
    k = feat.shape[1]
    out = torch.empty((num_segments, k + 6), device=feat.device,
                      dtype=torch.float32)
    seg_max = torch.empty((num_segments,), device=feat.device,
                          dtype=torch.float32)
    if num_segments == 0:
        return out, seg_max
    offsets = _offsets_for('softmax_aggregate_sorted', sorted_ids,
                           num_segments, offsets)
    from pointvs_tpu_torch.ops._build import load
    lib = load('segment_kernels')
    with torch.cuda.device(feat.device):
        err = lib.pvs_softmax_aggregate_sorted(
            feat.data_ptr(), logits.data_ptr(), trans.data_ptr(),
            mask.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            seg_max.data_ptr(), k, num_segments, int(mode == 'softmax'),
            _stream(feat.device))
    _raise_on(err, 'softmax_aggregate_sorted')
    fused_softmax_aggregate.launches += 1
    return out, seg_max


fused_softmax_aggregate.launches = 0

# The variants of csrc/segment_kernels.cu, in the order of
# pvs_segment_kernel_info: K1 with 4- or 16-byte columns, and with two
# 4-byte columns per lane; K2 with 4- or 16-byte feature columns.
KERNEL_VARIANTS = ('segment_sum_sorted<4B>', 'segment_sum_sorted<16B>',
                   'segment_sum_sorted<4B x2>',
                   'softmax_aggregate_sorted<4B>',
                   'softmax_aggregate_sorted<16B>')


def kernel_info() -> dict:
    """Registers, spills, shared bytes and resident blocks per SM of every
    K1/K2 variant on the current CUDA device (builds them if needed)."""
    from pointvs_tpu_torch.ops._build import read_kernel_info
    return {name: read_kernel_info('segment_kernels',
                                   'pvs_segment_kernel_info', i)
            for i, name in enumerate(KERNEL_VARIANTS)}


def _launch_counted():
    from pointvs_tpu_torch.ops.fused_egnn import fused_edge_forward
    from pointvs_tpu_torch.ops.fused_egnn_bwd import fused_edge_backward
    return {'segment_offsets': segment_offsets,
            'segment_sum_sorted': windowed_segment_sum,
            'softmax_aggregate_sorted': fused_softmax_aggregate,
            'fused_edge_forward': fused_edge_forward,
            'fused_edge_backward': fused_edge_backward}


def launch_counts() -> dict:
    """Launches so far of every CUDA kernel of the port (K1-K4), and the
    offset computations on a GPU, by name."""
    return {name: fn.launches for name, fn in _launch_counted().items()}


def reset_launch_counts() -> None:
    for fn in _launch_counted().values():
        fn.launches = 0
