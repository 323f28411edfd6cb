"""Edge-case graphs of the per-row kernels (the fused forward and the
per-edge SDDMM), shared by the CPU tests, which hold the port's plain
versions against the JAX package, and the card tests, which hold the
kernels against the plain versions. numpy only: the card's machine has no
JAX.

Each case is ``(scene_edges, scene_num_nodes, max_nodes, max_edges)``, the
arguments of ``build_graph_batch`` in both packages.
"""

from __future__ import annotations

import numpy as np


def swarm(scenes: int, robots: int, radius: float = 0.26, seed: int = 0):
    """Scenes of robots packed into consecutive slots, each with a radius
    graph over random positions (edges inside a scene only), as
    ``dynamic_swarm`` batches them: the rows of a scene share sources."""
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(scenes):
        p = rng.random((robots, 2))
        near = np.linalg.norm(p[None] - p[:, None], axis=-1) <= radius
        dst, src = np.nonzero(near & ~np.eye(robots, dtype=bool))
        edges.append(np.stack([src, dst]))
    n = scenes * robots
    return edges, [robots] * scenes, n, max(1, sum(e.shape[1] for e in edges))


def spread(nodes: int, per_row: int, seed: int = 0):
    """One scene whose destinations draw their sources uniformly from every
    node (so from every node tile), duplicates kept; every 7th destination
    has no in-edge."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(nodes), per_row)
    src = rng.integers(0, nodes, size=dst.shape)
    keep = dst % 7 != 3
    e = np.stack([src[keep], dst[keep]])
    return [e], [nodes], nodes, e.shape[1]


def degree(deg: int, nodes: int = 40):
    """One scene where node 0 has ``deg`` in-edges, cycling over the other
    nodes (duplicates once deg >= nodes), nodes 1 .. 9 one each and the
    rest none: an ELL width of ``deg`` rounded up to 8, with empty rows."""
    src0 = 1 + np.arange(deg) % (nodes - 1)
    e = np.concatenate([np.stack([src0, np.zeros(deg, np.int64)]),
                        np.stack([np.arange(2, 11), np.arange(1, 10)])], axis=1)
    return [e], [nodes], nodes + 8, e.shape[1]


def duplicates():
    """Duplicate edges, nodes without an in-edge, a scene without edges and
    padded node slots."""
    a = np.array([[1, 1, 2, 3, 0, 5, 5, 5],    # 1->0 twice, 5->4 three times
                  [0, 0, 0, 1, 2, 4, 4, 4]])   # nodes 3 and 5: no in-edge
    return [a, np.zeros((2, 0), np.int64)], [6, 3], 16, 8


# name -> (case, the card's size of it): the CPU tests run the small ones
# through the JAX package's kernels in interpret mode.
CASES = {
    "swarm": (lambda: swarm(3, 16), lambda: swarm(8, 32)),
    "spread": (lambda: spread(48, 6), lambda: spread(256, 12)),
    "duplicates": (duplicates, duplicates),
    "deg1": (lambda: degree(1), lambda: degree(1)),
    "deg32": (lambda: degree(32), lambda: degree(32, 200)),
    "deg128": (lambda: degree(128), lambda: degree(128, 200)),
    "deg129": (lambda: degree(129), lambda: degree(129, 200)),
    "deg200": (lambda: degree(200), lambda: degree(200, 256)),
}
WIDE = ("deg129", "deg200")  # past the fused kernels' 128 columns
