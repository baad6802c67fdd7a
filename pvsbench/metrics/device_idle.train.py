"""Share of the traced training window in which no kernel, copy or
memset ran on the card."""
from pvsbench.roofline import idle_share


def read(obs):
    return idle_share(obs, 'train')
