"""The ranks of a run as a (dp x gp) mesh of ``torch.distributed`` groups.

Counterpart of ``pointvs_tpu/parallel/mesh.py``. The reference drives a
JAX device mesh from one process per host; the port runs one process per
rank (``parallel/launch.py`` starts them) and describes the same mesh with
process groups:

- ``n_dp`` data-parallel rows by ``n_gp`` edge-parallel columns, gp the
  minor axis as in ``get_mesh_2d``: ``rank = dp_rank * n_gp + gp_rank``;
- ``dp_group`` joins the ranks of one column (the rows' gradients and the
  strict GraphNorm's whole-batch statistics sum over it), ``gp_group`` the
  ranks of one row (one graph batch's edge shards, whose aggregations sum
  over it); an axis of size 1 has no group (``batch_axis`` and
  ``edge_axis`` are then None, and nothing is reduced over it);
- ``replicate`` makes every rank hold rank 0's parameters (the
  reference's replicated placement);
- each rank holds only its own row of a batch, as the reference's
  multi-process path does (its ``shard_batch``): the loader collates this
  rank's stripe and, with graph sharding, its edge shard
  (``data/loader.py``).

Without an initialised process group the mesh is one rank, and nothing is
reduced.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class Mesh:
    """This process's place in the (dp x gp) mesh of the run's ranks."""

    def __init__(self, n_gp: int = 1):
        self.distributed = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if self.distributed else 1
        self.rank = dist.get_rank() if self.distributed else 0
        n_gp = max(1, int(n_gp))
        if self.world % n_gp:
            raise ValueError(f'{self.world} ranks are not divisible by '
                             f'graph_shard {n_gp}')
        self.n_gp = n_gp
        self.n_dp = self.world // n_gp
        self.dp_rank, self.gp_rank = divmod(self.rank, n_gp)
        self.dp_group = self.gp_group = None
        self.backend = dist.get_backend() if self.distributed else None
        if not self.distributed:
            return
        # new_group is collective: every rank creates every group, in the
        # same order, and keeps the two it belongs to.
        if self.n_dp > 1:
            for gp in range(n_gp):
                group = dist.new_group(
                    [dp * n_gp + gp for dp in range(self.n_dp)])
                if gp == self.gp_rank:
                    self.dp_group = group
        if n_gp > 1:
            for dp in range(self.n_dp):
                group = dist.new_group(
                    [dp * n_gp + gp for gp in range(n_gp)])
                if dp == self.dp_rank:
                    self.gp_group = group

    @property
    def chief(self) -> bool:
        """Rank 0: the one rank that writes files and logs."""
        return self.rank == 0

    @property
    def batch_axis(self):
        """The group a whole-batch statistic sums over, or None."""
        return self.dp_group

    @property
    def edge_axis(self):
        """The group an edge-sharded aggregation sums over, or None."""
        return self.gp_group

    def __repr__(self) -> str:
        return (f'Mesh(rank={self.rank}, world={self.world}, '
                f'dp={self.dp_rank}/{self.n_dp}, gp={self.gp_rank}/'
                f'{self.n_gp})')


def replicate(mesh: Mesh, model: torch.nn.Module) -> None:
    """Broadcast rank 0's parameters and buffers to every rank, in place
    (``replicate`` of the reference)."""
    if mesh.distributed:
        for t in model.state_dict().values():
            dist.broadcast(t, 0)
