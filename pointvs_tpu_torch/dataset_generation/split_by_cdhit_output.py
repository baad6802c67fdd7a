"""A train/test split from CD-HIT clusters (the port's own copy of
``pointvs_tpu/dataset_generation/split_by_cdhit_output.py``).

The ``.clstr`` output becomes a similarity graph over pdbids; whole
connected components move into the held-out set, drawn with a seeded
``random.Random``, until it holds ``1 - training_frac`` of the ids, so no
two similar proteins straddle the split.

Usage (writes ``<name>.train`` and ``<name>.test`` in the working
directory):
    python -m pointvs_tpu_torch.dataset_generation.split_by_cdhit_output \\
        <name>.out.clstr <train_frac>
"""
from __future__ import annotations

import argparse
import random
from collections import defaultdict, deque, namedtuple
from pathlib import Path


def bfs(graph, source):
    """Every node in the connected component of ``source``."""
    visited = {source}
    queue = deque(graph[source])
    while queue:
        node = queue.popleft()
        if node not in visited:
            visited.add(node)
            queue += graph[node]
    return visited


def cdhit_output_to_graph(fname):
    """A CD-HIT ``.clstr`` file -> {pdbid: deque of similar pdbids}."""
    graph = defaultdict(deque)
    cluster = set()

    def flush():
        for member in cluster:
            graph[member] += list(cluster.difference({member}))
        cluster.clear()

    with open(Path(fname).expanduser(), 'r', encoding='utf-8') as f:
        for line in f:
            if line.startswith('>Cluster'):
                flush()
            else:
                cluster.add(line.split('>')[-1].split('_')[0])
    flush()
    return {key: deque(set(val)) for key, val in graph.items()}


Dataset = namedtuple('Dataset', ['train', 'val'])


def generate_split(graph, training_frac: float, seed=None) -> Dataset:
    """Components drawn into ``val`` until it holds at least
    ``1 - training_frac`` of the graph's ids."""
    rng = random.Random(seed)
    train = set(graph.keys())
    total = len(train)
    val = set()
    while len(val) / total < 1 - training_frac:
        # Drawn from the set's iteration order, which string hashing sets
        # (PYTHONHASHSEED): one seed gives one split within a process.
        source = rng.sample(tuple(train), 1)[0]
        component = bfs(graph, source)
        train.discard(source)
        train -= component
        val.add(source)
        val.update(component)
    return Dataset(train, val)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Split pdbids by CD-HIT similarity clusters.')
    ap.add_argument('cdhit_output', help='CD-HIT xxx.out.clstr file')
    ap.add_argument('train_frac', type=float)
    args = ap.parse_args(argv)
    graph = cdhit_output_to_graph(args.cdhit_output)
    dataset = generate_split(graph, args.train_frac)
    base = Path(args.cdhit_output).name.split('.')[0]
    Path(base + '.train').write_text('\n'.join(sorted(dataset.train)))
    Path(base + '.test').write_text('\n'.join(sorted(dataset.val)))


if __name__ == '__main__':
    main()
