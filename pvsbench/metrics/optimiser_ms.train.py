"""Median host time of a training step's optimiser in the traced epochs
(the program's span ``pointvs.step.optimiser``: ``clip_and_step``, the
gradient clip and Adam)."""
from pvsbench.spans import median_ms


def read(obs):
    return median_ms(obs, 'train', ['pointvs.step.optimiser'])
