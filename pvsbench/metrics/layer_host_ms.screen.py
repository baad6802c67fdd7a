"""Median host time of one message-passing layer of the model's forward
in the traced re-screens (the program's span ``pointvs.model.layer``,
around each layer of ``SartorrasEGNN.embed``: the layer's dispatch, with
every wait for the card inside it)."""
from pvsbench.spans import median_ms


def read(obs):
    return median_ms(obs, 'screen', ['pointvs.model.layer'])
