"""Host time of a re-screen's passes over the library's files, in the
traced re-screens: the medians of the program's spans
``pointvs.screen.collect`` (the glob and the size sort, a ``stat`` a file)
and ``pointvs.screen.cache_key`` (the store cache's key, a ``stat`` a
file), summed."""
from pvsbench.spans import median_ms


def read(obs):
    return median_ms(obs, 'screen', ['pointvs.screen.collect',
                                     'pointvs.screen.cache_key'])
