"""The training window's model FLOPs (forward and backward products of
the graphs it trained, ``roofline.egnn_train_flops``) over its time, as a
share of the card's float32 peak."""
from pvsbench.roofline import model_flops_share


def read(obs):
    return model_flops_share(obs, 'train')
