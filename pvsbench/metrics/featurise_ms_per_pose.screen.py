"""Milliseconds a pose of the cold screen in set-up spent featurising,
which builds the library's store (``ScreenResult.seconds['featurise']``
over the poses)."""


def read(obs):
    if obs['kind'] != 'screen' or not obs.get('cold_poses'):
        return None
    return 1e3 * obs['cold']['featurise'] / obs['cold_poses']
