"""Host time of a re-screen's scoring, in the traced re-screens: the
medians of the program's spans ``pointvs.screen.eval`` (the dispatch of
every batch's eval step) and ``pointvs.screen.drain`` (the one copy back
of the logits, which waits for the card, and the rows), summed."""
from pvsbench.spans import median_ms


def read(obs):
    return median_ms(obs, 'screen', ['pointvs.screen.eval',
                                     'pointvs.screen.drain'])
