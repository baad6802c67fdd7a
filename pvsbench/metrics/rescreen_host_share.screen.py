"""Share of each re-screen's wall outside its score phase: the model's
load, the store's load from the cache and the bucket choice, and after
scoring the ranking and the CSV (``ScreenResult.seconds``: (total -
score) / total, summed over the window's calls)."""


def read(obs):
    if obs['kind'] != 'screen' or not obs['seconds']:
        return None
    total = sum(s['total'] for s in obs['seconds'])
    return 100.0 * sum(s['total'] - s['score'] for s in obs['seconds']) \
        / total
