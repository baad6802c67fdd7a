"""K2's least time from its launches' shapes over its device time, in the
traced re-screens."""
from pvsbench.roofline import kernel_roofline


def read(obs):
    return kernel_roofline(obs, 'screen', 'k2')
