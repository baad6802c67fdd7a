"""The window's model FLOPs (the forward products of every pose of each
re-screen, ``roofline.egnn_forward_flops``) over its time, as a share of
the card's float32 peak."""
from pvsbench.roofline import model_flops_share


def read(obs):
    return model_flops_share(obs, 'screen')
