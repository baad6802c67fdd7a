"""Median host time of a training step's dispatch in the traced epochs
(the program's span ``pointvs.train.step`` around the step function:
collation, forward, backward and the optimiser as the host enqueues
them); beside ``step_ms.train``, the step's time by CUDA events."""
from pvsbench.spans import median_ms


def read(obs):
    return median_ms(obs, 'train', ['pointvs.train.step'])
