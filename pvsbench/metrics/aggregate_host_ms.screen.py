"""Median host time of a layer's aggregation in the traced re-screens
(the program's span ``pointvs.model.aggregate``, inside
``pointvs.model.layer``: K2's or K1's call with its wrapper, whose
scalar copies wait for the card)."""
from pvsbench.spans import median_ms


def read(obs):
    return median_ms(obs, 'screen', ['pointvs.model.aggregate'],
                     within='pointvs.model.layer')
