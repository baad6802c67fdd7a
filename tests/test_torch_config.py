"""The port's training flags against the JAX package's (``config.py``).

For each command line, both packages' ``parse_args`` give equal namespaces
apart from the port's ``--device``, and ``model_kwargs_from_args`` gives
equal dicts. One command line sets every flag of the port's table with a
non-default value; the JAX parser must accept it.
"""
import pytest

from pointvs_tpu.config import model_kwargs_from_args as jax_model_kwargs
from pointvs_tpu.config import parse_args as jax_parse_args
from pointvs_tpu_torch.config import _FLAGS, model_kwargs_from_args, \
    parse_args


def _every_flag():
    argv = ['egnn', 'run']
    for name, _, kwargs in _FLAGS:
        if kwargs.get('action') == 'store_true':
            argv.append(name)
        elif 'choices' in kwargs:
            argv += [name, kwargs['choices'][-1]]
        elif kwargs.get('type') in (int, float):
            argv += [name, '3']
        else:
            argv += [name, 'x']
    return argv


ARGVS = {
    'defaults': ['egnn', 'run'],
    'readme': ['egnn', 'run', '--train_data_root_pose', 'data',
               '--train_types_pose', 't.types', '-ep', '2', '-k', '32',
               '--layers', '6', '--egnn_attention', '--softmax_attention',
               '--egnn_residual', '--egnn_normalise', '--egnn_tanh',
               '--graphnorm', '--compact', '-b', '32', '--top1'],
    'aliases': ['egnn', 'run', '-l', 'w.pt', '-b', '4', '-ep', '1', '-ea',
                '2', '-k', '8', '-lr', '0.01', '-w', '0', '-v', '-p', '-s',
                'sdf', '-o', 'sgd', '--tdra', 'aff'],
    'affinity': ['egnn', 'run', '--model_task', 'multi_regression',
                 '--train_types_affinity', 'a.types', '--regression_loss',
                 'huber', '--final_softplus', '--multi_fc'],
    'placement': ['egnn', 'run', '--node_attention_first_only',
                  '--edge_attention_final_only', '--no_scan_layers',
                  '--remat', '--dropout', '0.25'],
    'every_flag': _every_flag(),
}


@pytest.mark.parametrize('name', sorted(ARGVS))
def test_flags_and_model_kwargs_match_jax(name):
    argv = ARGVS[name]
    want = jax_parse_args(argv)
    got = parse_args(argv + ['--device', 'cpu'])
    got_vars = vars(got)
    assert got_vars.pop('device') == 'cpu'
    assert got_vars == vars(want)
    assert model_kwargs_from_args(got, 19) == jax_model_kwargs(want, 19)
