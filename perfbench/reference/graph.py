"""Frozen copies of the data rules the reference needs.

- The training stream's order of scenes and its scene seed.
- The communication-graph rules: robots j -> i within ``radius`` of each
  other in robot-index units (positions in metres over a 0.25 m slot
  spacing), or every other robot of the scene; no self loops; scenes laid
  out one after the other in the node axis, padded to ``max_nodes``.

Plain numpy and torch; nothing of the measured program is imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference.render import SLOT_SPACING_M


@dataclasses.dataclass(frozen=True)
class RefGraph:
    """A batch of scene graphs as plain edge lists (int64) over ``max_nodes``
    node slots; ``node_mask`` marks the slots that hold a robot."""
    src: torch.Tensor
    dst: torch.Tensor
    node_mask: torch.Tensor

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def to(self, device) -> "RefGraph":
        return RefGraph(self.src.to(device), self.dst.to(device),
                        self.node_mask.to(device))


def train_batch_scenes(num_scenes: int, scenes_per_batch: int, seed: int,
                       batch_index: int) -> np.ndarray:
    """The scene indices of training batch ``batch_index`` (within the
    first epoch) of the stream seeded with ``seed``: the scenes shuffled by
    (seed, epoch), taken ``scenes_per_batch`` at a time."""
    order = np.arange(num_scenes)
    np.random.default_rng([seed, 0]).shuffle(order)
    lo = batch_index * scenes_per_batch
    if lo + scenes_per_batch > num_scenes:
        raise ValueError("the checked batches must lie in the first epoch")
    return order[lo:lo + scenes_per_batch]


def train_scene_seed(seed: int) -> int:
    """The training split's scene seed for a stream seed."""
    return seed * 2


def _batch(scene_edges, sizes, max_nodes: int) -> RefGraph:
    src, dst, base = [], [], 0
    for (s, d), n in zip(scene_edges, sizes):
        src.append(s + base)
        dst.append(d + base)
        base += n
    if base > max_nodes:
        raise ValueError(f"{base} robots do not fit {max_nodes} node slots")
    mask = torch.zeros(max_nodes, dtype=torch.bool)
    mask[:base] = True
    cat = lambda xs: torch.from_numpy(  # noqa: E731
        np.concatenate(xs).astype(np.int64))
    return RefGraph(cat(src), cat(dst), mask)


def radius_graph(scene_positions_m, radius: float,
                 max_nodes: int) -> RefGraph:
    """Edges j -> i of each scene with |p_i - p_j| <= radius, positions in
    slot units (metres / 0.25)."""
    edges, sizes = [], []
    for pos in scene_positions_m:
        p = np.asarray(pos, np.float64) / SLOT_SPACING_M
        adj = np.abs(p[:, None] - p[None, :]) <= radius   # adj[i, j]
        np.fill_diagonal(adj, False)
        dst, src = np.nonzero(adj)
        edges.append((src, dst))
        sizes.append(len(p))
    return _batch(edges, sizes, max_nodes)


def full_graph(num_scenes: int, num_robots: int, max_nodes: int) -> RefGraph:
    """Every robot of a scene sends to every other robot of it."""
    i, j = np.nonzero(~np.eye(num_robots, dtype=bool))  # i dst, j src
    return _batch([(j, i)] * num_scenes, [num_robots] * num_scenes,
                  max_nodes)
