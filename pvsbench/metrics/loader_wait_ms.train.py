"""Median wait of the training loop for its next batch in the traced
epochs (the program's span ``pointvs.train.next_batch``: the consumer's
wait for the loader's producer thread; an epoch's first fetch also runs
the loader's set-up of the epoch)."""
from pvsbench.spans import median_ms


def read(obs):
    return median_ms(obs, 'train', ['pointvs.train.next_batch'])
