"""K1's least time from its launches' shapes over its device time, in the
traced training window."""
from pvsbench.roofline import kernel_roofline


def read(obs):
    return kernel_roofline(obs, 'train', 'k1')
