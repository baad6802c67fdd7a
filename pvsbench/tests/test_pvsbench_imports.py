"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Top-level module names are compared
whole, so ``pointvs_tpu_torch`` is not taken for ``pointvs_tpu``."""
import ast
import subprocess
import sys

from pvsbench import harness

RUN_MODULES = ['pvsbench.harness', 'pvsbench.control', 'pvsbench.trace',
               'pvsbench.inputs', 'pvsbench.roofline']


def loaded_top_level(code: str) -> set:
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys\n'
         'print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))'],
        capture_output=True, text=True, check=True, cwd=harness.REPO)
    return set(out.stdout.split())


def test_harness_kinds_metrics_and_port_load_no_jax():
    code = '\n'.join(
        [f'import {m}' for m in RUN_MODULES]
        + ['from pvsbench import harness',
           'import pointvs_tpu_torch.screen, pointvs_tpu_torch.main',
           'import pointvs_tpu_torch.training.engine',
           'for k in ("train", "rescreen"): harness.kind_module(k)',
           'for m in harness.manifest()["per_layer"]:',
           '    harness.metric_reader(m["name"])'])
    names = loaded_top_level(code)
    assert 'pointvs_tpu_torch' in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    names = loaded_top_level(
        'import pvsbench.reference.egnn, pvsbench.reference.featurise, '
        'pvsbench.reference.train')
    assert not names & {'pointvs_tpu_torch', *harness.FORBIDDEN}


def test_reference_sources_import_nothing_of_either_package():
    for path in (harness.PACKAGE / 'reference').glob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split('.')[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or '').split('.')[0]]
            else:
                continue
            assert not set(tops) & {'pointvs_tpu_torch',
                                    *harness.FORBIDDEN}, (path, tops)


def test_forbidden_names_are_compared_whole():
    before = set(sys.modules)
    sys.modules['pointvs_tpu_torch_x'] = sys
    try:
        assert 'pointvs_tpu_torch_x' not in harness.forbidden_modules()
    finally:
        for name in set(sys.modules) - before:
            del sys.modules[name]
