"""Host time of a training epoch outside its steps, in the traced epochs:
the medians of the program's spans ``pointvs.train.epoch_setup`` (the
schedule, the store's switch-on, the step's build) and
``pointvs.train.epoch_end`` (the epoch's log and checkpoint), summed."""
from pvsbench.spans import median_ms


def read(obs):
    return median_ms(obs, 'train', ['pointvs.train.epoch_setup',
                                    'pointvs.train.epoch_end'])
