"""Median training step of the window by the Trainer's CUDA events
(``Trainer.step_ms``)."""
import statistics


def read(obs):
    if obs['kind'] != 'train' or not obs['step_ms']:
        return None
    return statistics.median(obs['step_ms'])
