"""Median host time of a training step's collation in the traced epochs
(the program's span ``pointvs.step.collate`` inside ``pointvs.train.step``:
``collate_from_ids`` from the device store, with its ids copy)."""
from pvsbench.spans import median_ms


def read(obs):
    return median_ms(obs, 'train', ['pointvs.step.collate'],
                     within='pointvs.train.step')
