"""Share of the edges the traced re-screens' eval batches computed that
were real: the program's counts ``pointvs.screen.real_edges`` over
``pointvs.screen.padded_edges`` (the batches' bucket edges, every one of
which each layer computes), summed over the traced re-screens. Nothing
from a program that keeps no counts."""


def counts(obs: dict) -> list:
    """The program's counts of this run, ``(name, value)``; taken from the
    program at the first call and kept in ``obs``."""
    if 'program_counts' not in obs:
        try:
            from pointvs_tpu_torch.tracing import take_counts
        except ImportError:   # a program without counts
            obs['program_counts'] = []
        else:
            obs['program_counts'] = take_counts()
    return obs['program_counts']


def read(obs):
    if obs['kind'] != 'screen':
        return None
    total = {}
    for name, value in counts(obs):
        total[name] = total.get(name, 0) + value
    padded = total.get('pointvs.screen.padded_edges')
    if not padded:
        return None
    return 100.0 * total.get('pointvs.screen.real_edges', 0) / padded
