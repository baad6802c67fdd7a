"""``pointvs_tpu_torch.scripts.for_steph`` (raw PDB/SDF inputs ->
parquets -> predictions) against the JAX package's, on a 2-layer
multi-regression model trained by the port's CLI that both packages load:
the types file, the parquets (column for column) and the predictions
(every path equal, every value within the file's printed precision)."""
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from pointvs_tpu.scripts.for_steph import \
    generate_types_file as jax_generate_types_file
from pointvs_tpu.scripts.for_steph import \
    predict_on_molecular_inputs as jax_predict
from pointvs_tpu_torch.main import main as port_main
from pointvs_tpu_torch.scripts.for_steph import (
    generate_types_file,
    main,
    predict_on_molecular_inputs,
)

TESTS = Path(__file__).parent
MANIFEST = 'resources/7zzp_rec_0.pdb resources/7zzp_lig_0.sdf\n'


@pytest.mark.parametrize('manifest', [
    MANIFEST, MANIFEST + 'a.pdb b.mol2\nmalformed line here\n', ''])
def test_generate_types_file_matches_jax(tmp_path, manifest):
    inputs = tmp_path / 'inputs.txt'
    inputs.write_text(manifest)
    generate_types_file(inputs, tmp_path / 'port.types')
    jax_generate_types_file(inputs, tmp_path / 'jax.types')
    assert (tmp_path / 'port.types').read_text() == \
        (tmp_path / 'jax.types').read_text()


@pytest.fixture(scope='module')
def affinity_run(tmp_path_factory):
    root = tmp_path_factory.mktemp('steph')
    types = root / 'affinity.types'
    types.write_text('4.0 4.1 4.2 rec_0.parquet lig_0.parquet\n'
                     '5.0 5.1 5.2 rec_0.parquet lig_0.parquet\n')
    port_main(['egnn', str(root / 'model'), '--train_data_root_affinity',
               str(TESTS / 'resources'), '--train_types_affinity',
               str(types), '--model_task', 'multi_regression', '--layers',
               '2', '-k', '16', '-ea', '1', '-b', '2', '--compact',
               '--prefetch', '0', '--device', 'cpu'])
    return root


def _rows(path):
    return [line.split() for line in path.read_text().splitlines()]


def test_predict_on_molecular_inputs_matches_jax(affinity_run, tmp_path):
    manifest = tmp_path / 'inputs.txt'
    manifest.write_text(MANIFEST)
    outs = {name: tmp_path / name for name in ('port', 'jax')}
    for out in outs.values():
        out.mkdir()
    want = jax_predict(input_fnames=manifest, data_root=TESTS,
                       model_path=affinity_run / 'model',
                       output_dir=outs['jax'])
    got = predict_on_molecular_inputs(
        input_fnames=manifest, data_root=TESTS,
        model_path=affinity_run / 'model', output_dir=outs['port'],
        device='cpu')
    assert got.name == want.name == 'affinity_predictions.txt'
    assert (outs['port'] / 'inputs.types').read_text() == \
        (outs['jax'] / 'inputs.types').read_text()
    for name in ('7zzp_rec_0.parquet', '7zzp_lig_0.parquet'):
        g, w = (pd.read_parquet(out / 'parquets' / 'resources' / name)
                for out in (outs['port'], outs['jax']))
        pd.testing.assert_frame_equal(g, w)
    got_rows, want_rows = _rows(got), _rows(want)
    assert len(got_rows) == len(want_rows) == 1
    for g, w in zip(got_rows, want_rows):
        assert len(g) == 5
        assert [Path(p).relative_to(outs['port']) for p in g[3:]] == \
            [Path(p).relative_to(outs['jax']) for p in w[3:]]
        assert g[3].endswith('7zzp_rec_0.parquet')
        np.testing.assert_allclose([float(v) for v in g[:3]],
                                   [float(v) for v in w[:3]], atol=1.1e-3)


def test_cli_writes_the_predictions(affinity_run, tmp_path):
    manifest = tmp_path / 'inputs.txt'
    manifest.write_text(MANIFEST)
    preds = main(['-i', str(manifest), '-d', str(TESTS), '-m',
                  str(affinity_run / 'model'), '-o', str(tmp_path / 'out'),
                  '--device', 'cpu'])
    assert preds == tmp_path / 'out' / 'affinity_predictions.txt'
    assert ' | ' not in preds.read_text()
    assert all(np.isfinite(float(v)) for v in _rows(preds)[0][:3])
