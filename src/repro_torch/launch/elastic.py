"""Elastic re-meshing: resume a checkpoint on a different number of ranks —
port of ``repro/launch/elastic.py``.

Checkpoints are topology-free (whole leaves on the host keyed by their
tree path, ``checkpoint/manager.py``), so elasticity is a placement
problem: build the new mesh, compute each leaf's placement on it with the
same policy (``models/sharding.Sharder``), and keep this rank's slice of
each whole leaf.  A world that lost ranks restarts on a smaller mesh and
continues from the latest step; a grown one runs with more data
parallelism.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.sharding import Sharder
from repro_torch.tree import tree_map, unflatten


@dataclass(frozen=True)
class Placement:
    """A leaf's placement on a mesh: its spec (one entry a dimension) and
    the sharder whose coordinates say which slice this rank keeps (the
    reference's ``NamedSharding(mesh, spec)``)."""

    sharder: Sharder
    spec: tuple

    def cut(self, x: torch.Tensor) -> torch.Tensor:
        return self.sharder.cut(x, self.spec)


def reshard(tree, spec_tree):
    """This rank's slice of every whole leaf of ``tree`` by its
    ``Placement`` in ``spec_tree`` (a tree of ``tree``'s structure; None
    keeps the leaf whole)."""
    return tree_map(lambda x, s: s.cut(x) if s is not None else x, tree, spec_tree)


def remesh_state(state, cfg, new_mesh, *, sharder=None):
    """Re-place a TrainState of whole leaves on ``new_mesh`` with the standard
    policy: (the TrainState of this rank's slices, the Sharder).  The
    sharder is ``Sharder(new_mesh, cfg)`` unless one is given."""
    sharder = sharder or Sharder(new_mesh, cfg)
    placement = sharder.train_placement()
    pspec = unflatten(state.params, [Placement(sharder, sp if placement.on else ())
                                     for sp in placement.specs])
    spec = state._replace(params=pspec, opt=state.opt._replace(step=None, m=pspec, v=pspec),
                          err=None if state.err is None else pspec)
    return reshard(state, spec), sharder
