"""Host time of a re-screen's store, in the traced re-screens: the
medians of the program's spans ``pointvs.screen.store_load`` (the cached
store's read from ``--cache_dir``) and ``pointvs.screen.store_upload``
(its copy to the card), summed."""
from pvsbench.spans import median_ms


def read(obs):
    return median_ms(obs, 'screen', ['pointvs.screen.store_load',
                                     'pointvs.screen.store_upload'])
