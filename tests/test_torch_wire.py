"""The port's wire codec (``pointvs_tpu_torch/data/wire.py``) and its host
half in the native library (``native_symhalf``) against the JAX package's
``pointvs_tpu/data/wire.py``.

Seeded numpy graphs (one-hot node features, symmetric edge lists whose
mirrors share their class) go through the JAX package's collator at fixed
padded sizes. On each batch: ``compress`` gives the reference's format and
every field array-equal to the reference's, for v1, v2 (``prefer_v2``),
v3, ``POINTVS_WIRE_V3=0``, a non-symmetric batch, the legacy [N] ids (a
graph id order that is not non-decreasing) and the legacy [E] classes
(``e_pad % 4 != 0``); ``pack`` and ``pack_stacked`` are byte-equal to the
reference's. The port's decode on the CPU gives every field of the host
batch bit for bit, and the reference's ``decompress(unpack(...))`` on
JAX's CPU gives the same fields, also where a field starts at an offset
its dtype cannot be viewed at. ``native_symhalf`` agrees with
``_symhalf_numpy`` on eligible rows and on each kind of ineligible row,
and a failed build of the native library raises in ``compress``. The
loader applies ``transfer_fn`` in its producer thread and re-raises its
errors in the consumer. The ``cuda`` cases decode on the card; the JAX
package is imported by module-scoped fixtures only, so that
``python -m pytest --noconftest -m cuda tests/test_torch_wire.py`` runs
where there is no JAX.
"""
import threading

import numpy as np
import pytest
import torch

from pointvs_tpu_torch.data import wire
from pointvs_tpu_torch.data.buckets import GraphBatch, GraphSample, \
    pad_graphs_to_batch, to_device
from pointvs_tpu_torch.native import build as native

F = 12


@pytest.fixture(scope='module')
def ref_wire():
    from pointvs_tpu.data import wire as ref
    return ref


@pytest.fixture(scope='module')
def ref_pad():
    """The JAX package's collator, over the port's samples."""
    from pointvs_tpu.data.buckets import GraphSample as RefSample, \
        pad_graphs_to_batch

    def pad(samples, **kwargs):
        return pad_graphs_to_batch([RefSample(
            node_feats=s.node_feats, coords=s.coords, senders=s.senders,
            receivers=s.receivers, edge_attr=s.edge_attr, y=s.y)
            for s in samples], **kwargs)
    return pad


def _samples(rng, n_graphs, symmetric=True):
    """Graphs of 8-20 nodes with one-hot features and radius-like edges:
    each unordered pair kept with p = 0.3 in both directions (mirrors of
    one class), or, for ``symmetric=False``, one direction of each pair
    dropped with p = 0.3."""
    out = []
    for _ in range(n_graphs):
        n = int(rng.randint(8, 21))
        feats = np.zeros((n, F), np.float32)
        feats[np.arange(n), rng.randint(0, F, n)] = 1.0
        feats[:, -1] = rng.randint(0, 2, n)
        i, j = np.triu_indices(n, 1)
        keep = rng.rand(len(i)) < 0.3
        i, j = i[keep], j[keep]
        cls = rng.randint(0, 3, len(i))
        rows, cols = np.concatenate([i, j]), np.concatenate([j, i])
        cls = np.concatenate([cls, cls])
        if not symmetric:
            keep = rng.rand(len(rows)) > 0.3
            rows, cols, cls = rows[keep], cols[keep], cls[keep]
        order = np.lexsort((cols, rows))
        attr = np.zeros((len(order), 3), np.float32)
        attr[np.arange(len(order)), cls[order]] = 1.0
        out.append(GraphSample(
            node_feats=feats, coords=rng.randn(n, 3).astype(np.float32),
            senders=rows[order].astype(np.int32),
            receivers=cols[order].astype(np.int32), edge_attr=attr,
            y=np.float32(rng.randint(0, 2)), lig_fname='', rec_fname=''))
    return out


def _batch(seed, n_graphs=3, n_pad=128, e_extra=40, e_mod=8, e_rem=0,
           symmetric=True, e_pad=None) -> GraphBatch:
    """A collated host batch with a spare slot, padded to ``n_pad`` nodes
    and to the first edge count past the real ones plus ``e_extra`` that
    is ``e_rem`` modulo ``e_mod`` (or to ``e_pad``)
    (``test_port_collator_gives_the_reference_batch`` holds the port's
    collator against the reference's)."""
    rng = np.random.RandomState(seed)
    samples = _samples(rng, n_graphs, symmetric)
    e = sum(len(s.senders) for s in samples) + e_extra
    e += (e_rem - e) % e_mod
    batch = pad_graphs_to_batch(samples, num_graphs=n_graphs + 1,
                                n_pad=n_pad, e_pad=e_pad or e)
    return batch._replace(strain=rng.rand(n_graphs + 1, 2).astype(
        np.float32))


def _legacy_ids(batch):
    """Graphs 0 and 1 swap ids: graph_id is no longer non-decreasing."""
    gid = np.array(batch.graph_id)
    gid = np.where(gid == 0, 1, np.where(gid == 1, 0, gid)).astype(np.int32)
    return batch._replace(graph_id=gid)


# name -> (batch, compress keywords, environment, reference format)
CASES = {
    'v1': (lambda: _batch(0), {}, {'POINTVS_WIRE_V3': '0'}, 'WireBatch'),
    'v2': (lambda: _batch(1), {'prefer_v2': True}, {}, 'WireBatchV2'),
    'v3': (lambda: _batch(2), {}, {}, 'WireBatchV3'),
    'v3_odd_class_bytes': (lambda: _batch(3, e_mod=16, e_rem=8), {}, {},
                           'WireBatchV3'),
    'asymmetric': (lambda: _batch(4, symmetric=False), {}, {}, 'WireBatch'),
    'legacy_ids': (lambda: _legacy_ids(_batch(5)), {}, {}, 'WireBatch'),
    'legacy_classes': (lambda: _batch(6, e_mod=4, e_rem=2), {}, {},
                       'WireBatch'),
}


@pytest.fixture
def case(request, monkeypatch):
    make, kwargs, env, fmt = CASES[request.param]
    monkeypatch.delenv('POINTVS_WIRE_V3', raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    return make(), kwargs, fmt


def _fields_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for name in want._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize('case', sorted(CASES), indirect=True)
def test_compress_and_pack_match_jax(case, ref_wire):
    batch, kwargs, fmt = case
    got = wire.compress(batch, **kwargs)
    want = ref_wire.compress(batch, **kwargs)
    assert type(got).__name__ == fmt
    _fields_equal(got, want)
    assert np.array_equal(wire.pack(got), ref_wire.pack(want))
    assert wire.nbytes(wire.template(got)) == len(ref_wire.pack(want))


@pytest.mark.parametrize('name', ['v1', 'v2', 'v3'])
def test_pack_stacked_matches_jax(name, monkeypatch, ref_wire):
    make, kwargs, env, fmt = CASES[name]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    rows = [_batch(10 + d, n_pad=256, e_pad=1024) for d in range(2)]
    stacked = type(rows[0])(*[
        None if getattr(rows[0], f) is None
        else np.stack([getattr(r, f) for r in rows])
        for f in rows[0]._fields])
    got = wire.compress(stacked, **kwargs)
    want = ref_wire.compress(stacked, **kwargs)
    assert type(got).__name__ == fmt
    _fields_equal(got, want)
    packed = wire.pack_stacked(got)
    assert np.array_equal(packed, ref_wire.pack_stacked(want))
    tmpl = wire.stacked_template(got)
    assert packed.shape == (2, wire.nbytes(tmpl))
    for d in range(2):   # each row decodes to its own batch
        row = wire.decode(torch.from_numpy(packed[d]), tmpl, True)
        _assert_batch_equal(row, to_device(rows[d], torch.device('cpu')))


def _assert_batch_equal(got: GraphBatch, want: GraphBatch):
    for name in GraphBatch._fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


def _ref_decode(ref_wire, want, symmetric):
    import jax.numpy as jnp
    buf = jnp.asarray(ref_wire.pack(want))
    return ref_wire.decompress(
        ref_wire.unpack(buf, ref_wire.wire_template(want)), symmetric)


@pytest.mark.parametrize('case', sorted(CASES), indirect=True)
def test_decode_equals_the_host_batch_and_jax(case, ref_wire):
    host, kwargs, _ = case
    symmetric = host.inv_recv_perm is not None
    got_wire = wire.compress(host, **kwargs)
    tmpl = wire.template(got_wire)
    got = wire.decode(torch.from_numpy(wire.pack(got_wire)), tmpl,
                      symmetric)
    _assert_batch_equal(got, to_device(host, torch.device('cpu')))
    want = _ref_decode(ref_wire, ref_wire.compress(host, **kwargs),
                       symmetric)
    for name in GraphBatch._fields:
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None, name
            continue
        g = getattr(got, name).numpy()
        assert g.dtype == np.asarray(w).dtype, name
        assert np.array_equal(g, np.asarray(w)), name


def _offsets(tmpl):
    out, offset = {}, 0
    for name, field in zip(tmpl._fields, tmpl):
        out[name] = offset
        offset += field.nbytes
    return out


@pytest.mark.parametrize('name', ['legacy_classes', 'v3_odd_class_bytes'])
def test_misaligned_fields_decode(name, monkeypatch):
    """A field after the legacy [E] classes or an odd count of v3 class
    bytes starts where its dtype cannot be viewed: it is copied, and the
    decode is still the host batch; so is a row of a group whose rows
    have an odd length."""
    make, kwargs, env, _ = CASES[name]
    monkeypatch.delenv('POINTVS_WIRE_V3', raising=False)
    host = make()
    packed = wire.compress(host, **kwargs)
    tmpl = wire.template(packed)
    assert _offsets(tmpl)['y'] % 4 != 0
    raw = wire.pack(packed)
    want = to_device(host, torch.device('cpu'))
    _assert_batch_equal(wire.decode(torch.from_numpy(raw), tmpl,
                                    host.inv_recv_perm is not None), want)
    # Three rows of odd length: rows 1 and 2 start at odd offsets.
    odd = np.concatenate([raw, np.zeros(1 - len(raw) % 2, np.uint8)])
    group = wire.upload([odd, odd, odd], torch.device('cpu'))
    assert group.data.shape == (3, len(odd)) and len(odd) % 2
    for i in range(3):
        row = group.data[i, :len(raw)]
        _assert_batch_equal(wire.decode(row, tmpl,
                                        host.inv_recv_perm is not None),
                            want)


def _row(batch):
    return (np.asarray(batch.senders), np.asarray(batch.receivers),
            np.asarray(batch.recv_perm), wire._edge_class(batch),
            batch.node_feats.shape[0])


def _ineligible(kind):
    """One edge list (senders, receivers, recv_perm, classes, n_pad) that
    v3 cannot take, by ``kind``."""
    s, r, rp, ec, n_pad = _row(_batch(20))
    s, r, rp, ec = s.copy(), r.copy(), rp.copy(), ec.copy()
    if kind == 'unsorted':
        s[[0, 1]], r[[0, 1]] = s[[1, 0]], r[[1, 0]]
        if s[0] == s[1] and r[0] == r[1]:
            s[[0, 2]], r[[0, 2]] = s[[2, 0]], r[[2, 0]]
    elif kind == 'broken_mirror':
        rp[[0, 1]] = rp[[1, 0]]
    elif kind == 'unpaired':   # a real edge where a padding edge was
        last = int(np.flatnonzero(s < n_pad)[-1]) + 1
        s[last], r[last] = s[last - 1], min(r[last - 1] + 1, n_pad - 1)
    elif kind == 'self_loop':
        s, r = np.concatenate([[0], s[:-1]]), np.concatenate([[0], r[:-1]])
        rp = np.argsort(r, kind='stable').astype(np.int32)
        ec = np.concatenate([[0], ec[:-1]]).astype(np.uint8)
    elif kind == 'padding_sender':   # sender n_pad, receiver real
        r[-1] = 0
    elif kind == 'length':
        s, r, rp, ec = s[:-4], r[:-4], rp[:-4], ec[:-4]
    return s, r, rp, ec, n_pad


INELIGIBLE = ('unsorted', 'broken_mirror', 'unpaired', 'self_loop',
              'padding_sender', 'length')


@pytest.mark.parametrize('kind', ['eligible', 'all_padding'] +
                         list(INELIGIBLE))
def test_native_symhalf_matches_numpy(kind, ref_wire):
    if kind == 'eligible':
        args = _row(_batch(21))
    elif kind == 'all_padding':
        args = (np.full(64, 128, np.int32), np.full(64, 128, np.int32),
                np.arange(64, dtype=np.int32), np.full(64, 3, np.uint8), 128)
    else:
        args = _ineligible(kind)
    got = native.native_symhalf(*args)
    want = wire._symhalf_numpy(*args)
    if kind in INELIGIBLE:
        assert got is None and want is None
        return
    assert got is not None and want is not None
    for g, w, r in zip(got, want, ref_wire._symhalf_numpy(*args)):
        assert g.dtype == w.dtype == r.dtype
        assert np.array_equal(g, w) and np.array_equal(g, r)


def test_a_failed_build_raises_in_compress(tmp_path, monkeypatch):
    """No compiler: v3 compression raises instead of taking numpy."""
    monkeypatch.setenv('POINTVS_NATIVE_CACHE', str(tmp_path / 'empty'))
    monkeypatch.setattr(native.shutil, 'which', lambda name: None)
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
            wire.compress(_batch(22))
    finally:
        native.load.cache_clear()


@pytest.mark.parametrize('symmetric', [True, False])
def test_port_collator_gives_the_reference_batch(symmetric, ref_wire,
                                                 ref_pad):
    samples = _samples(np.random.RandomState(23), 3, symmetric)
    ref = ref_pad(samples, num_graphs=4, n_pad=128, e_pad=512)
    port = pad_graphs_to_batch(samples, num_graphs=4, n_pad=128, e_pad=512)
    for name in GraphBatch._fields:
        w = getattr(ref, name)
        if w is None:
            assert getattr(port, name) is None, name
        else:
            assert np.array_equal(getattr(port, name), np.asarray(w)), name
    assert np.array_equal(wire.pack(wire.compress(port)),
                          ref_wire.pack(ref_wire.compress(ref)))


class _Loader:
    """The loader's producer machinery over a list of items."""

    def __init__(self, items, prefetch):
        from pointvs_tpu_torch.data.loader import GraphDataLoader
        self.impl = GraphDataLoader.__new__(GraphDataLoader)
        self.impl.prefetch = prefetch
        self.impl.transfer_fn = None
        self.impl._produce = lambda: iter(items)


@pytest.mark.parametrize('prefetch', [0, 2])
def test_transfer_runs_in_the_producer_thread(prefetch):
    items = [(i, None) for i in range(5)]
    loader = _Loader(items, prefetch).impl
    threads = []

    def transfer(batch):
        threads.append(threading.current_thread())
        return ('sent', batch)

    loader.transfer_fn = transfer
    source = (loader._prefetched() if prefetch
              else (loader._apply_transfer(i) for i in loader._produce()))
    assert [b for b, _ in source] == [('sent', i) for i in range(5)]
    main = threading.main_thread()
    assert all((t is main) == (prefetch == 0) for t in threads)


def test_transfer_errors_reach_the_consumer():
    loader = _Loader([(i, None) for i in range(3)], 2).impl

    def transfer(batch):
        if batch == 1:
            raise ValueError('packing failed')
        return batch

    loader.transfer_fn = transfer
    got = []
    with pytest.raises(ValueError, match='packing failed'):
        for batch, _ in loader._prefetched():
            got.append(batch)
    assert got == [0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['v1', 'v2', 'v3', 'legacy_classes'])
def test_decode_on_the_card(cuda_device, name, monkeypatch):
    make, kwargs, env, _ = CASES[name]
    monkeypatch.delenv('POINTVS_WIRE_V3', raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    host = make()
    packed = wire.compress(host, **kwargs)
    staged = wire.upload_pack(packed, cuda_device)
    got = wire.decode(staged, wire.template(packed),
                      host.inv_recv_perm is not None)
    _assert_batch_equal(got, to_device(host, cuda_device))
