"""The device-resident dataset on the card against the host (``cuda``
marker; this file imports no JAX, so it runs where JAX is not installed).

- ``collate_from_ids`` on the card equals the host's
  ``pad_graphs_to_batch`` in every field, bit for bit, for full, partial
  and repeated ids, from a plain store and from a hybrid store refreshed
  for two epochs.
- The rotation matrices on the card are within 1e-6 of the CPU's, and
  the rotated coordinates within 3e-6 of their scale.
- A chunk expanded on the card equals the one expanded on the CPU, in the
  raw codec and in the half-edge codec (its two stable sorts).

Run on a machine with a GPU:
    python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda_device_dataset.py
"""
import numpy as np
import pytest
import torch

from pointvs_tpu_torch.data import device_dataset as dd
from pointvs_tpu_torch.data.buckets import (DEFAULT_EDGE_BUCKETS,
                                            DEFAULT_NODE_BUCKETS,
                                            pad_graphs_to_batch, pick_bucket)
from pointvs_tpu_torch.data.dataset import PointCloudDataset
from tests.setup_and_params import RESOURCES

DS_KW = dict(radius=6, edge_radius=4, compact=True, polar_hydrogens=False,
             model_task='classification')


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    return torch.device('cuda')


def _dataset(**kw):
    return PointCloudDataset(RESOURCES, RESOURCES / 'test.types',
                             **dict(DS_KW, **kw))


def _assert_equal_to_host(dataset, store, ids, slots):
    samples = [dataset[i] for i in ids]
    n_pad = pick_bucket(sum(s.num_nodes for s in samples),
                        DEFAULT_NODE_BUCKETS)
    e_pad = pick_bucket(sum(s.num_edges for s in samples),
                        DEFAULT_EDGE_BUCKETS)
    spec = dd.DeviceCollateSpec(n_pad, e_pad, slots, store.host.symmetric,
                                False)
    got = dd.collate_from_ids(store.arrays,
                              np.array(ids + [-1] * (slots - len(ids))),
                              spec)
    want = pad_graphs_to_batch(samples, num_graphs=slots, n_pad=n_pad,
                               e_pad=e_pad)
    for field in want._fields:
        w = getattr(want, field)
        g = getattr(got, field)
        if w is None:
            assert g is None, field
            continue
        assert g.device.type == 'cuda', field
        g = g.cpu().numpy()
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), field


@pytest.mark.cuda
@pytest.mark.parametrize('ids, slots', [([0, 1], 2), ([1], 3),
                                        ([1, 1, 0], 4)],
                         ids=['full', 'partial', 'repeated'])
def test_collation_on_the_card_equals_the_host(ids, slots, cuda_device):
    dataset = _dataset()
    store = dd.DeviceGraphStore(dd.build_host_store(dataset), cuda_device)
    _assert_equal_to_host(dataset, store, ids, slots)


@pytest.mark.cuda
def test_hybrid_tail_on_the_card_equals_the_host(cuda_device):
    dataset = _dataset(augmented_active_count=2,
                       augmented_active_min_angle=30)
    store = dd.DeviceGraphStore(dd.build_host_store(dataset), cuda_device)
    for epoch in (1, 2):
        store.prefetch_refresh(dataset, epoch)
        store.refresh(dataset, epoch)
        dataset.set_epoch(epoch)
        _assert_equal_to_host(dataset, store, list(range(len(dataset))),
                              len(dataset))


@pytest.mark.cuda
def test_rotation_on_the_card_matches_the_cpu(cuda_device):
    host = dd.build_host_store(_dataset())
    ids = np.array([0, 1, -1])
    spec = dd.DeviceCollateSpec(512, 8192, 3, host.symmetric, True)
    key = dd.rotation_key(2, 5)
    mats = [dd.random_rotations(key, ids, device).cpu()
            for device in (cuda_device, torch.device('cpu'))]
    torch.testing.assert_close(mats[0], mats[1], atol=1e-6, rtol=0)
    coords = []
    for device in (cuda_device, torch.device('cpu')):
        batch = dd.collate_from_ids(dd.DeviceGraphStore(host, device).arrays,
                                    ids, spec)
        coords.append(dd.rotate_per_graph(batch, key, ids, 3).coords.cpu())
    # Each coordinate sums three products with matrix entries held at
    # 1e-6: relative to the coordinates' scale, within 3e-6.
    scale = coords[1].abs().max().item()
    torch.testing.assert_close(coords[0], coords[1], atol=3e-6 * scale,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('raw', [True, False], ids=['raw', 'half'])
def test_chunk_expands_on_the_card_as_on_the_cpu(cuda_device, raw):
    host = dd.build_host_store(_dataset())
    ranges, spec = dd.plan_chunks(host, host.nbytes / 2, raw=raw)
    assert spec.half and spec.raw == raw
    for lo, hi in ranges:
        packed = dd.pack_chunk(host, lo, hi, spec)
        got, want = (dd.expand_chunk(dd.upload_chunk(packed, device), spec)
                     for device in (cuda_device, torch.device('cpu')))
        for field in dd.DeviceStoreArrays._fields:
            assert torch.equal(getattr(got, field).cpu(),
                               getattr(want, field)), field
