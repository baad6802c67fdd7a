"""The port's device-resident dataset (``pointvs_tpu_torch/data/
device_dataset.py``) against the JAX package's, on the CPU.

- The host store's arrays equal JAX's ``build_host_store`` for the same
  dataset (plain, and with an augmented tail), and its flags.
- ``collate_from_ids`` equals the port's ``pad_graphs_to_batch`` in every
  field, bit for bit, and JAX's ``collate_from_ids``, for full, partial
  and repeated ids.
- ``random_rotations`` within 1e-6 of JAX's for the same key and ids;
  proper rotations (det +1, orthonormal within 1e-6) keyed by item, not
  slot; coordinates' norms and distances kept, padding rows zero.
- The eligibility gates, the ``auto`` thresholds and the refusals of
  ``--device_cache on`` where the JAX package refuses it.
- Ids batches of the loader equal the streaming loader's batch for batch,
  the hybrid tail across 3 epochs, with the background prefetch and with
  a synchronous refresh; under tiny ``POINTVS_AUG_*`` caps the slots,
  graphs and reject and fallback counts equal JAX's over 10 epochs.
- ``pack_chunk`` -> ``expand_chunk`` reproduces the store exactly with the
  lossless codecs, the raw ones and the reference's other codec (half
  and full uint16 edge lists, ``raw=False``), whose packed buffers and
  expanded arrays also equal JAX's bit for bit; coords16 within JAX's bound (scale / 2), its arrays
  equal to JAX's ``expand_chunk`` (coordinates within one rounding
  step); ``plan_chunks`` within budget, the reference's
  backstop case included; the codecs' gates.
- The store file round trip, and no reading of another format's file.
- ``main --device_cache on`` follows JAX's ``main --device_cache on``
  (20 steps from one ``.pt``, atol 1e-4 / rtol 1e-5).

The reference's ``batch_row_cap`` (the TPU kernels' window capacity) has
no counterpart, so ``test_cap_measurement_matches_host`` has none here.
"""
import jax
import numpy as np
import pytest
import torch

from pointvs_tpu.data import device_dataset as jdd
from pointvs_tpu.data.dataset import PointCloudDataset as JaxDataset
from pointvs_tpu.main import main as jax_main
from pointvs_tpu_torch.data import device_dataset as dd
from pointvs_tpu_torch.data.buckets import (DEFAULT_EDGE_BUCKETS,
                                            DEFAULT_NODE_BUCKETS,
                                            pad_graphs_to_batch, pick_bucket)
from pointvs_tpu_torch.data.dataset import PointCloudDataset
from pointvs_tpu_torch.data.loader import GraphDataLoader
from pointvs_tpu_torch.main import main as port_main
from pointvs_tpu_torch.models.params import load_reference_checkpoint, \
    state_dict_from_flax
from pointvs_tpu_torch.training.engine import Trainer
from tests.setup_and_params import ORIGINAL_GRAPH, RESOURCES
from tests.test_torch_egnn import jax_model_and_params
from tests.test_torch_main import CLI_MODEL, MODEL_FLAGS, TRAJ_TOL
from tests.test_torch_screen import write_library
from tests.test_torch_train_loader import write_types

CPU = torch.device('cpu')
DS_KW = dict(radius=6, edge_radius=4, compact=True, polar_hydrogens=False,
             model_task='classification')


def _datasets(root, types, **kw):
    kw = dict(DS_KW, **kw)
    return (PointCloudDataset(root, types, **kw),
            JaxDataset(root, types_fname=types, **kw))


@pytest.fixture(scope='module')
def library(tmp_path_factory):
    """Five poses of the test ligand (three perturbed, two copies) and the
    two test complexes against their receptors: (data root, types)."""
    root = tmp_path_factory.mktemp('dd_lib')
    lib = write_library(root)
    for name in ('rec_0.parquet', 'rec.parquet', 'lig.parquet'):
        (lib / name).write_bytes((RESOURCES / name).read_bytes())
    lines = [f'{i % 2} -1 -1 rec_0.parquet {p.name}'
             for i, p in enumerate(sorted(lib.glob('[pc]o*.parquet')))]
    lines += ['1 -1 -1 rec.parquet lig.parquet']
    types = root / 'lib.types'
    types.write_text('\n'.join(lines) + '\n')
    return lib, types


@pytest.fixture(scope='module')
def stores(library):
    port_ds, jax_ds = _datasets(*library)
    return port_ds, dd.build_host_store(port_ds), jdd.build_host_store(jax_ds)


def _aug_datasets(**kw):
    return _datasets(RESOURCES, RESOURCES / 'test.types',
                     augmented_active_count=2,
                     augmented_active_min_angle=30, **kw)


def _assert_store_equal(got, want):
    for name in want.arrays._fields:
        a, b = getattr(got.arrays, name), getattr(want.arrays, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(got.num_nodes, want.num_nodes)
    np.testing.assert_array_equal(got.num_edges, want.num_edges)
    assert (got.symmetric, got.rot, got.aug_from) == (
        want.symmetric, want.rot, want.aug_from)
    assert got.lig_fnames == want.lig_fnames
    assert got.nbytes == sum(a.nbytes for a in want.arrays)


def test_host_store_matches_jax(stores):
    port_ds, got, want = stores
    assert len(got.num_nodes) == len(port_ds) == 6
    assert got.symmetric and not got.rot
    assert got.arrays.feats.dtype == np.uint8
    _assert_store_equal(got, want)


def test_hybrid_host_store_matches_jax():
    port_ds, jax_ds = _aug_datasets()
    got, want = dd.build_host_store(port_ds), jdd.build_host_store(jax_ds)
    assert got.aug_from == 2 and len(got.num_nodes) == 6
    # Augmented slots hold their capacity: spare rows past the item.
    slots = np.diff(got.arrays.node_start)
    assert np.all(slots[2:] >= got.arrays.node_len[2:])
    _assert_store_equal(got, want)


def _pads(samples):
    return (pick_bucket(sum(s.num_nodes for s in samples),
                        DEFAULT_NODE_BUCKETS),
            pick_bucket(sum(s.num_edges for s in samples),
                        DEFAULT_EDGE_BUCKETS))


def _assert_batch_equal(got, want, name=''):
    for field in want._fields:
        w = getattr(want, field)
        g = getattr(got, field)
        if w is None:
            assert g is None, f'{name} {field}'
            continue
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, f'{name} {field}'
        # Bytes, not values: +0.0 and -0.0 would compare equal.
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), \
            f'{name} {field}'


IDS = {'full': ([0, 1, 2, 3, 4, 5], 6), 'partial': ([4, 5], 4),
       'repeated': ([1, 1, 0, 5], 6)}


@pytest.mark.parametrize('name', sorted(IDS))
def test_collate_matches_host_and_jax(stores, name):
    port_ds, host, jax_host = stores
    ids, slots = IDS[name]
    samples = [port_ds[i] for i in ids]
    n_pad, e_pad = _pads(samples)
    spec = dd.DeviceCollateSpec(n_pad, e_pad, slots, host.symmetric, False)
    padded = np.array(ids + [-1] * (slots - len(ids)), np.int32)
    store = dd.DeviceGraphStore(host, CPU)
    got = dd.collate_from_ids(store.arrays, padded, spec)
    want = pad_graphs_to_batch(samples, num_graphs=slots, n_pad=n_pad,
                               e_pad=e_pad)
    assert want.inv_recv_perm is not None
    _assert_batch_equal(got, want, name)
    jspec = jdd.DeviceCollateSpec(n_pad, e_pad, slots, jax_host.symmetric,
                                  False)
    jax_batch = jax.jit(lambda a, i: jdd.collate_from_ids(a, i, jspec))(
        jax_host.arrays, padded)
    for field in want._fields:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(),
            np.asarray(getattr(jax_batch, field)), err_msg=field)


def test_random_rotations_match_jax():
    key = jax.random.fold_in(jax.random.PRNGKey(3), dd.ROTATION_SALT)
    ids = np.array([0, 5, 1, 7, 3, 5, -1, 1000], np.int32)
    got = dd.random_rotations(np.asarray(key), ids).numpy()
    want = np.asarray(jdd.random_rotations(key, ids))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    eye = np.eye(3, dtype=np.float32)
    for m in got:
        np.testing.assert_allclose(m @ m.T, eye, atol=1e-6)
        assert abs(np.linalg.det(m.astype(np.float64)) - 1) <= 1e-6
    # Keyed by item, not slot: item 5 twice, and the reversed layout.
    np.testing.assert_array_equal(got[1], got[5])
    rev = dd.random_rotations(np.asarray(key), ids[::-1].copy()).numpy()
    np.testing.assert_array_equal(rev, got[::-1])
    assert not np.allclose(got[0], got[2])
    # The Trainer's key for a step: JAX's fold of its step key.
    trainer_rng = jax.random.split(jax.random.PRNGKey(2))[1]
    np.testing.assert_array_equal(
        dd.rotation_key(2, 7),
        np.asarray(jax.random.fold_in(jax.random.fold_in(trainer_rng, 7),
                                      dd.ROTATION_SALT)))


def test_rotation_keeps_invariants(stores):
    port_ds, host, _ = stores
    ids = np.array([0, 1, 2, -1], np.int32)
    n_pad, e_pad = _pads([port_ds[i] for i in ids[:3]])
    spec = dd.DeviceCollateSpec(n_pad, e_pad, 4, host.symmetric, True)
    batch = dd.collate_from_ids(dd.DeviceGraphStore(host, CPU).arrays, ids,
                                spec)
    key = dd.rotation_key(0, 3)
    rot = dd.rotate_per_graph(batch, key, ids, 4)
    c0, c1 = batch.coords.numpy(), rot.coords.numpy()
    np.testing.assert_allclose(np.linalg.norm(c1, axis=1),
                               np.linalg.norm(c0, axis=1), atol=1e-4)
    pad = batch.node_mask.numpy() == 0
    assert pad.any() and np.all(c1[pad] == 0)
    for g in range(3):
        sel = batch.graph_id.numpy() == g
        d0 = np.linalg.norm(c0[sel][:, None] - c0[sel][None], axis=-1)
        d1 = np.linalg.norm(c1[sel][:, None] - c1[sel][None], axis=-1)
        np.testing.assert_allclose(d1, d0, atol=1e-3)
    jspec = jdd.DeviceCollateSpec(n_pad, e_pad, 4, host.symmetric, True)
    jbatch = jdd.collate_from_ids(stores[2].arrays, ids, jspec)
    want = jdd.rotate_per_graph(jbatch, key, ids, 4)
    np.testing.assert_allclose(c1, np.asarray(want.coords), atol=1e-5,
                               rtol=0)


def test_rotation_recorded_only_where_getitem_rotates(library):
    ds = PointCloudDataset(*library, rot=True, **DS_KW)
    assert dd.build_host_store(ds).rot and ds.rot

    class IgnoresRot(PointCloudDataset):
        def __getitem__(self, item):
            return super().__getitem__(item)

    ign = IgnoresRot(*library, rot=True, **DS_KW)
    assert dd.build_host_store(ign).rot is False


def test_eligibility_gates(monkeypatch):
    class FakeDataset:
        p_remove_entity = 0
        p_noise = -1
        pre_aug_ds_len = 10

        def __len__(self):
            return 10

        def set_epoch(self, epoch):
            pass

    ds = FakeDataset()
    for fn in (dd.store_eligibility, jdd.store_eligibility):
        assert fn(ds) is None
    ds.p_noise = 0.1
    assert 'p_noise' in dd.store_eligibility(ds)
    ds.p_noise = -1
    ds.p_remove_entity = 0.5
    assert 'p_remove_entity' in dd.store_eligibility(ds)
    ds.p_remove_entity = 0
    ds.pre_aug_ds_len = 8
    assert dd.store_eligibility(ds) is None
    monkeypatch.setenv('POINTVS_DD_HYBRID', '0')
    assert 'POINTVS_DD_HYBRID' in dd.store_eligibility(ds)
    assert dd.store_eligibility(ds) == jdd.store_eligibility(ds)


def _train_loader(dataset, **kw):
    return GraphDataLoader(dataset, **dict(dict(
        batch_size=2, mode='train', prefetch=0, seed=3), **kw))


def test_auto_thresholds_and_switches(library, tmp_path, monkeypatch):
    """``auto`` streams above POINTVS_DD_AUTO_MB and past
    POINTVS_DD_BUDGET_MB, ``on`` takes the store past both, ``off`` and
    POINTVS_DEVICE_DATASET=0 never take it; one store per dataset."""
    ds = PointCloudDataset(*library, **DS_KW)

    def trainer(mode):
        return Trainer('egnn', tmp_path / mode, CPU, silent=True,
                       device_cache=mode, dim_input=12, dim_output=1, k=16,
                       num_layers=1)

    def enabled(t):
        dl = _train_loader(ds)
        t._maybe_enable_device_dataset(dl)
        return dl.device_store

    auto = trainer('auto')
    store = enabled(auto)
    assert store is not None and enabled(auto) is store
    assert enabled(trainer('off')) is None
    for var in ('POINTVS_DD_AUTO_MB', 'POINTVS_DD_BUDGET_MB'):
        monkeypatch.setenv(var, '0.0001')
        assert enabled(trainer('auto')) is None
        assert enabled(trainer('on')) is not None
        monkeypatch.delenv(var)
    monkeypatch.setenv('POINTVS_DEVICE_DATASET', '0')
    assert enabled(trainer('on')) is None
    with pytest.raises(ValueError, match='device_cache'):
        Trainer('egnn', tmp_path / 'x', CPU, silent=True,
                device_cache='yes', dim_input=12, dim_output=1, k=16,
                num_layers=1)


REFUSED = {
    'pair_layout': ('siamese', []),
    'dense_layout': ('lie_conv', []),
    'p_noise': ('egnn', ['--p_noise', '0.3']),
    'p_remove_entity': ('egnn', ['--p_remove_entity', '0.3']),
}


@pytest.mark.parametrize('name', sorted(REFUSED))
def test_device_cache_on_refuses_where_jax_does(tmp_path, name):
    model, extra = REFUSED[name]
    argv = [model, '', '--train_data_root_pose', str(RESOURCES),
            '--train_types_pose', str(RESOURCES / 'test.types'), '-b', '2',
            '-ep', '1', '--layers', '1', '-k', '8', '--radius', '4',
            '--device_cache', 'on'] + extra
    for run_main, tail in ((port_main, ['--device', 'cpu']),
                           (jax_main, ['--num_devices', '1'])):
        argv[1] = str(tmp_path / run_main.__module__)
        with pytest.raises(ValueError, match='device_cache on'):
            run_main(argv + tail)


def _ids_batch(item):
    batch, meta = item
    assert batch[0] == 'ids'
    return dd.collate_from_ids(batch[2].arrays, batch[1][0], batch[3]), meta


def test_loader_ids_batches_match_streaming(library):
    """Weighted sampling over two epochs: the same index stream, buckets,
    metadata and batches."""
    ds = PointCloudDataset(*library, **DS_KW)
    stream = _train_loader(ds, batch_size=4)
    ids_loader = _train_loader(ds, batch_size=4)
    ids_loader.enable_device_dataset(
        dd.DeviceGraphStore(dd.build_host_store(ds), CPU))
    assert stream.use_weighted_sampler
    for _ in range(2):
        pairs = list(zip(stream, ids_loader))
        assert len(pairs) == len(stream) == 2
        for (sb, sm), item in pairs:
            batch, meta = _ids_batch(item)
            assert meta.lig_fnames == sm.lig_fnames
            np.testing.assert_array_equal(meta.y.reshape(sm.y.shape), sm.y)
            np.testing.assert_array_equal(meta.graph_mask.reshape(-1),
                                          sm.graph_mask)
            _assert_batch_equal(batch, sb)


@pytest.mark.parametrize('refresh', ['prefetch', 'sync'])
def test_hybrid_loader_matches_streaming(refresh, monkeypatch):
    """Augmented actives across 3 epochs: the refreshed tail gives the
    streaming loader's batches, whether the next epoch's graphs come from
    the background prefetch or are featurised at the epoch's start."""
    stream_ds, _ = _aug_datasets()
    ids_ds, _ = _aug_datasets()
    if refresh == 'sync':
        monkeypatch.setattr(dd.DeviceGraphStore, 'prefetch_refresh',
                            lambda self, dataset, epoch: None)
    stream = _train_loader(stream_ds, batch_size=3, seed=7)
    ids_loader = _train_loader(ids_ds, batch_size=3, seed=7)
    store = dd.DeviceGraphStore(dd.build_host_store(ids_ds), CPU)
    ids_loader.enable_device_dataset(store)
    tails = []
    for epoch in range(3):
        for (sb, sm), item in zip(stream, ids_loader):
            batch, meta = _ids_batch(item)
            assert meta.lig_fnames == sm.lig_fnames
            _assert_batch_equal(batch, sb, f'epoch {epoch}')
        assert store.host.aug_epoch[0] == epoch
        assert (store._prefetch is not None) == (refresh == 'prefetch')
        tails.append(store.arrays.coords[
            int(store.host.arrays.node_start[2]):].clone())
    assert not torch.equal(tails[0], tails[1])


def test_forced_aug_rejections_match_jax(monkeypatch):
    """Tiny augmented-active caps (slack 0.05, one probe, two retries, as
    the JAX package's ``test_hybrid_spill_free_under_forced_rejections``
    sets them) run the reject and fallback paths hot: the store's slots,
    the caps, every epoch's graphs and the reject and fallback counts
    equal JAX's, and the refreshed store collates the streaming graphs,
    over 10 epochs."""
    for name, value in (('POINTVS_AUG_SLACK_N', '0.05'),
                        ('POINTVS_AUG_SLACK_E', '0.05'),
                        ('POINTVS_AUG_PROBES', '1'),
                        ('POINTVS_AUG_RETRIES', '2')):
        monkeypatch.setenv(name, value)
    (ds, jax_ds), (stream_ds, jax_stream) = _aug_datasets(), _aug_datasets()
    host = dd.build_host_store(ds)
    _assert_store_equal(host, jdd.build_host_store(jax_ds))
    store = dd.DeviceGraphStore(host, CPU)
    ids = list(range(len(ds)))
    for epoch in range(10):
        store.refresh(ds, epoch)     # raises if a draw outgrew its slot
        stream_ds.set_epoch(epoch)
        jax_stream.set_epoch(epoch)
        samples = [stream_ds[i] for i in ids]
        for i in ids:
            want = jax_stream[i]
            for field in ('node_feats', 'coords', 'senders', 'receivers',
                          'edge_attr'):
                np.testing.assert_array_equal(
                    getattr(samples[i], field), getattr(want, field),
                    err_msg=f'epoch {epoch} item {i} {field}')
        for i in ids[stream_ds.pre_aug_ds_len:]:
            n_cap, e_cap = stream_ds.aug_size_cap(i)
            assert (n_cap, e_cap) == jax_stream.aug_size_cap(i)
            assert samples[i].num_nodes <= n_cap
            assert samples[i].num_edges <= e_cap
        n_pad, e_pad = _pads(samples)
        spec = dd.DeviceCollateSpec(n_pad, e_pad, len(ids), host.symmetric,
                                    False)
        _assert_batch_equal(
            dd.collate_from_ids(store.arrays, np.asarray(ids, np.int32),
                                spec),
            pad_graphs_to_batch(samples, num_graphs=len(ids), n_pad=n_pad,
                                e_pad=e_pad), f'epoch {epoch}')
    assert ds.aug_rejects > 0
    assert ds.aug_rejects == stream_ds.aug_rejects == jax_stream.aug_rejects
    assert (ds.aug_fallbacks == stream_ds.aug_fallbacks
            == jax_stream.aug_fallbacks)


def test_aug_item_and_prefetched_refresh_match_sync():
    ds, _ = _aug_datasets()
    for epoch in (0, 3):
        ds.set_epoch(epoch)
        for i in range(ds.pre_aug_ds_len, len(ds)):
            a, b = ds.aug_item(i, epoch), dd._norot_getitem(ds, i)
            for field in ('node_feats', 'coords', 'senders', 'receivers',
                          'edge_attr'):
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(b, field))
            assert float(a.y) == float(b.y) == 0.0
            assert (a.lig_fname, a.rec_fname) == (b.lig_fname, b.rec_fname)
    (sync_ds, _), (pf_ds, _) = _aug_datasets(), _aug_datasets()
    sync = dd.DeviceGraphStore(dd.build_host_store(sync_ds), CPU)
    pf = dd.DeviceGraphStore(dd.build_host_store(pf_ds), CPU)
    pf.prefetch_refresh(pf_ds, 1)
    assert pf._prefetch is not None
    sync.refresh(sync_ds, 1)
    pf.refresh(pf_ds, 1)
    assert pf._prefetch is None
    for name in dd.DeviceStoreArrays._fields:
        assert torch.equal(getattr(pf.arrays, name),
                           getattr(sync.arrays, name)), name


def _expand(host, lo, hi, spec):
    return dd.expand_chunk(dd.upload_chunk(dd.pack_chunk(host, lo, hi, spec),
                                           CPU), spec)


# The raw codec by the encodings each case switches off; 'half' and 'full'
# are the other codec (raw=False) on the mirrored store and on the store
# taken as not mirrored.
CODECS = {'default': {}, 'uint16': dict(rperm12=False, deg8=False),
          'explicit_senders': dict(degrees=False, deg8=False),
          'half': None, 'full': None}


@pytest.mark.parametrize('codec', sorted(CODECS))
def test_chunk_codec_reproduces_the_store(stores, codec, monkeypatch):
    _, host, jax_host = stores
    raw = CODECS[codec] is not None
    if codec == 'full':
        monkeypatch.setattr(dd, '_mirrored', lambda _: False)
        jax_host = jax_host._replace(symmetric=False)
    ranges, spec = dd.plan_chunks(host, host.nbytes / 3, raw=raw)
    assert len(ranges) >= 3 and spec.raw == raw
    assert spec.half == (codec != 'full')
    if raw:
        assert spec.degrees and spec.coords16 and spec.rperm12 and spec.deg8
        spec = spec._replace(coords16=False, **CODECS[codec])
    else:
        jranges, jspec = jdd.plan_chunks(jax_host, host.nbytes / 3,
                                         raw=False)
        assert ranges == jranges and spec._asdict() == jspec._asdict()
        assert not (spec.degrees or spec.coords16 or spec.rperm12
                    or spec.deg8)
        jax_expand = jax.jit(lambda p: jdd.expand_chunk(p, jspec))
    a = host.arrays
    device_store = dd.DeviceGraphStore(host, CPU).arrays
    for lo, hi in ranges:
        packed = dd.pack_chunk(host, lo, hi, spec)
        got = dd.expand_chunk(dd.upload_chunk(packed, CPU), spec)
        if not raw:
            jpacked = jdd.pack_chunk(jax_host, lo, hi, jspec)
            assert sorted(packed) == sorted(jpacked)
            for key, value in packed.items():
                assert value.dtype == jpacked[key].dtype, key
                np.testing.assert_array_equal(value, jpacked[key],
                                              err_msg=key)
            want = jax_expand(packed)
            for field in dd.DeviceStoreArrays._fields:
                np.testing.assert_array_equal(
                    getattr(got, field).numpy(),
                    np.asarray(getattr(want, field)), err_msg=field)
        n_lo, n_hi = int(a.node_start[lo]), int(a.node_start[hi])
        e_lo, e_hi = int(a.edge_start[lo]), int(a.edge_start[hi])
        n, e, c = n_hi - n_lo, e_hi - e_lo, hi - lo
        for field, want in (
                ('feats', a.feats[n_lo:n_hi]),
                ('coords', a.coords[n_lo:n_hi]),
                ('senders', a.senders[e_lo:e_hi].astype(np.int32)),
                ('receivers', a.receivers[e_lo:e_hi].astype(np.int32)),
                ('rperm', a.rperm[e_lo:e_hi].astype(np.int32)),
                ('eclass', a.eclass[e_lo:e_hi])):
            np.testing.assert_array_equal(
                getattr(got, field)[:len(want)].numpy(), want,
                err_msg=field)
        np.testing.assert_array_equal(got.node_len[:c].numpy(),
                                      a.node_len[lo:hi])
        np.testing.assert_array_equal(got.y[:c].numpy(), a.y[lo:hi])
        # A batch of the chunk's items collates as from the whole store.
        ids = np.arange(lo, hi, dtype=np.int32)
        cspec = dd.DeviceCollateSpec(n_pad=n + 128, e_pad=e + 512,
                                     num_graphs=c + 1,
                                     symmetric=host.symmetric, rotate=False)
        _assert_batch_equal(
            dd.collate_from_ids(got, np.append(ids - lo, -1), cspec),
            dd.collate_from_ids(device_store, np.append(ids, -1), cspec))


def test_chunk_coords16_within_bound_and_matches_jax(stores):
    _, host, jax_host = stores
    ranges, spec = dd.plan_chunks(host, host.nbytes / 3)
    jranges, jspec = jdd.plan_chunks(jax_host, host.nbytes / 3)
    assert ranges == jranges and spec._asdict() == jspec._asdict()
    a = host.arrays
    for lo, hi in ranges:
        got = _expand(host, lo, hi, spec)
        want = jax.jit(lambda p: jdd.expand_chunk(p, jspec))(
            jdd.pack_chunk(jax_host, lo, hi, jspec))
        for field in dd.DeviceStoreArrays._fields:
            g, w = getattr(got, field).numpy(), np.asarray(getattr(want,
                                                                   field))
            if field == 'coords':
                # XLA's CPU code contracts some lanes of lo + q * scale into
                # one fused multiply-add; the port rounds the product
                # first: one rounding step of the largest coordinate apart.
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=np.spacing(np.abs(w).max()))
            else:
                np.testing.assert_array_equal(g, w, err_msg=field)
        n_lo, n_hi = int(a.node_start[lo]), int(a.node_start[hi])
        real = a.coords[n_lo:n_hi]
        bound = (real.max(axis=0) - real.min(axis=0)) / 131070.0 * 1.01 \
            + 1e-5
        err = np.abs(got.coords[:n_hi - n_lo].numpy() - real)
        assert (err <= bound).all() and err.max() > 0


def test_chunk_codec_gates(stores):
    _, host, _ = stores
    _, spec = dd.plan_chunks(host, host.nbytes)
    assert spec.rperm12 and spec.deg8 and spec.degrees
    el = host.arrays.edge_len.copy()
    el[0] = 4096
    big = host._replace(arrays=host.arrays._replace(edge_len=el))
    assert not dd.plan_chunks(big, host.nbytes)[1].rperm12
    wide = host._replace(arrays=host.arrays._replace(
        rperm=host.arrays.rperm.astype(np.int32)))
    assert not dd.plan_chunks(wide, host.nbytes)[1].degrees
    # The other codec: none of the raw encodings, half the edge slots of
    # a mirrored store, and no item past what uint16 ids can name.
    _, lists = dd.plan_chunks(host, float('inf'), raw=False)
    assert not (lists.raw or lists.degrees or lists.coords16
                or lists.rperm12 or lists.deg8)
    half_edges = int(host.arrays.edge_len.sum()) // 2
    assert lists.half and lists.eh_fix == -(-half_edges // 4) * 4
    num_nodes = host.num_nodes.copy()
    num_nodes[0] = 0xffff
    huge = host._replace(num_nodes=num_nodes)
    with pytest.raises(ValueError, match='uint16'):
        dd.plan_chunks(huge, host.nbytes, raw=False)


def _sized_store(nodes, edges, feat_dim=17):
    """A HostStore with only the sizes set: item i has nodes[i] nodes and
    edges[i] edges (expanded bytes nodes * (feat_dim + 12) + 13 edges)."""
    node_start = np.concatenate([[0], np.cumsum(nodes)]).astype(np.int32)
    edge_start = np.concatenate([[0], np.cumsum(edges)]).astype(np.int32)
    arrays = dd.DeviceStoreArrays(
        feats=np.zeros((node_start[-1], feat_dim), np.uint8),
        coords=np.zeros((node_start[-1], 3), np.float32),
        senders=np.zeros(edge_start[-1], np.uint16),
        receivers=np.zeros(edge_start[-1], np.uint16),
        rperm=np.zeros(edge_start[-1], np.uint16),
        eclass=np.zeros(edge_start[-1], np.uint8), node_start=node_start,
        edge_start=edge_start, node_len=np.diff(node_start),
        edge_len=np.diff(edge_start), y=np.zeros(len(nodes), np.float32),
        strain=np.zeros((len(nodes), 2), np.float32))
    return dd.HostStore(arrays, np.asarray(nodes), np.asarray(edges), [], [],
                        True, False, 0, len(nodes), [0])


def test_plan_chunks_stays_within_budget(stores):
    """Every multi-item range's expanded bytes fit the budget (a single
    item past it is its own range), the ranges cover the store in order;
    and the reference's backstop case, per-item bytes [29, 29, 1316] at a
    budget of 40, where the JAX package gives one 58-byte range of two
    items, takes one item a range here."""
    _, host, _ = stores
    a = host.arrays
    per_item = (np.diff(a.node_start) * float(a.feats.shape[1] + 12)
                + np.diff(a.edge_start) * 13.0)
    for frac in (0.51, 0.34, 0.26):
        budget = float(per_item.sum()) * frac
        ranges, _ = dd.plan_chunks(host, budget)
        assert ranges[0][0] == 0 and ranges[-1][1] == len(per_item)
        assert all(hi == lo2 for (_, hi), (lo2, _) in zip(ranges,
                                                           ranges[1:]))
        assert all(float(per_item[lo:hi].sum()) <= budget
                   for lo, hi in ranges if hi - lo > 1)
    skewed = _sized_store([1, 1, 1], [0, 0, 99])
    assert dd.plan_chunks(skewed, 40)[0] == [(0, 1), (1, 2), (2, 3)]
    assert jdd.plan_chunks(skewed, 40)[0][0] == (0, 2)


def test_store_file_round_trip(stores, tmp_path):
    _, host, jax_host = stores
    path = tmp_path / 'store.bin'
    dd.save_host_store(host, path)
    loaded = dd.load_host_store(path)
    _assert_store_equal(loaded, host)
    assert loaded.rec_fnames == host.rec_fnames
    assert list(tmp_path.iterdir()) == [path]
    jdd.save_host_store(jax_host, path)
    assert dd.load_host_store(path) is None
    assert dd.load_host_store(tmp_path / 'missing.bin') is None


@pytest.fixture(scope='module')
def on_runs(tmp_path_factory):
    """``main --device_cache on`` of both packages, 20 steps from one
    ``.pt``."""
    root = tmp_path_factory.mktemp('dd_cli')
    types = write_types(root / 'train.types', n=40,
                        labels=lambda i: int(i % 3 == 0))
    _, params = jax_model_and_params(MODEL_FLAGS, ORIGINAL_GRAPH, False,
                                     seed=6)
    weights = root / 'init.pt'
    torch.save({'model_state_dict': state_dict_from_flax(params),
                'p_epoch': 0, 'a_epoch': 0}, weights)

    def argv(save):
        return ['egnn', str(save), '--train_data_root_pose', str(RESOURCES),
                '--train_types_pose', str(types), '--test_data_root_pose',
                str(RESOURCES), '--test_types_pose',
                str(RESOURCES / 'test.types'), '-b', '2', '-ep', '1',
                '--dropout', '0', '--load_weights', str(weights),
                '--num_devices', '1', '--prefetch', '0', '--device_cache',
                'on'] + CLI_MODEL

    jax_trainer = jax_main(argv(root / 'jax'))
    port_trainer = port_main(argv(root / 'port') + ['--device', 'cpu'])
    return root, jax_trainer, port_trainer


def test_main_device_cache_on_matches_jax(on_runs):
    root, jax_trainer, port_trainer = on_runs
    losses = np.asarray(port_trainer.train_losses)
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert len(port_trainer._device_stores) == 2   # training and test sets
    import json
    logged = {r['Batch (train, pose)']: r['Loss (train, pose)']
              for r in map(json.loads, (root / 'jax' / 'metrics.jsonl')
                           .read_text().splitlines())
              if 'Loss (train, pose)' in r}
    assert sorted(logged) == [1, 11]
    for batch, loss in logged.items():
        np.testing.assert_allclose(losses[batch - 1], loss, **TRAJ_TOL)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jax_trainer.params))
    got, _ = load_reference_checkpoint(
        root / 'port' / 'checkpoints' / 'pose_ckpt_epoch_1.pt')
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                   err_msg=key, **TRAJ_TOL)
    rows = [(root / run / 'pose_predictions.txt').read_text().split()
            for run in ('jax', 'port')]
    assert len(rows[0]) == len(rows[1]) > 0
    for g, w in zip(rows[1], rows[0]):
        if g.replace('.', '').isdigit():
            assert abs(float(g) - float(w)) <= 1.1e-3
        else:
            assert g == w


def test_store_sorts_unsorted_items_as_the_host_collator(tmp_path):
    """``SynthPharmDataset``'s edges come unsorted. The JAX package's store
    refuses them, so its ``main --synthpharm`` stops under the default
    ``--device_cache auto`` (ROADMAP.md, Queue 3); the port's store sorts
    each item's edges stably by sender, as the host collator sorts a
    batch, collates the host's batch bit for bit, and ``main
    --synthpharm`` gives the same predictions with it as without it."""
    from pointvs_tpu.data.dataset import SynthPharmDataset as JaxSynth
    from pointvs_tpu_torch.data.dataset import SynthPharmDataset
    from tests.test_torch_synthpharm import write_synthpharm_set
    types = write_synthpharm_set(tmp_path / 'sp', n=4)
    kw = dict(compact=True, radius=4, edge_radius=4, polar_hydrogens=False,
              model_task='classification')
    ds = SynthPharmDataset(types.parent, types, **kw)
    assert not np.all(np.diff(ds[0].senders) >= 0)
    with pytest.raises(ValueError, match='sender-sorted'):
        jdd.build_host_store(JaxSynth(types.parent, types_fname=types, **kw))
    host = dd.build_host_store(ds)
    ids = [2, 0, 3]
    samples = [ds[i] for i in ids]
    n_pad, e_pad = _pads(samples)
    spec = dd.DeviceCollateSpec(n_pad, e_pad, 4, host.symmetric, False)
    _assert_batch_equal(
        dd.collate_from_ids(dd.DeviceGraphStore(host, CPU).arrays,
                            np.array(ids + [-1]), spec),
        pad_graphs_to_batch(samples, num_graphs=4, n_pad=n_pad,
                            e_pad=e_pad))
    scores = {}
    for mode in ('auto', 'off'):
        trainer = port_main([
            'egnn', str(tmp_path / mode), '--train_data_root_pose',
            str(types.parent), '--train_types_pose', str(types),
            '--test_data_root_pose', str(types.parent), '--test_types_pose',
            str(types), '--synthpharm', '--compact', '-b', '2', '-ep', '1',
            '--layers', '2', '-k', '8', '--radius', '4', '--device_cache',
            mode, '--device', 'cpu'])
        assert len(trainer._device_stores) == (2 if mode == 'auto' else 0)
        scores[mode] = trainer.val_scores
    np.testing.assert_array_equal(scores['auto'], scores['off'])
