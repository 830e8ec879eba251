"""Non-NN heuristic homozygote caller over edge-transition graphs.

The reference walks, per candidate, a greedy two-path through the group's
edge matrices — pick the two heaviest non-deletion edges at the first
link, then from each current node follow its heaviest outgoing edge —
forward and reversed, calling the site homozygous when the two paths meet
at the center in either direction (heuristic.py:18-98). The pandas
row-lookup loops become argmax sweeps vectorized over all N candidates at
once here.

Tie-breaking: the reference's pandas sort_values(ascending=False) leaves
tie order unspecified (quicksort); we take the first maximum in edge-label
order (np.argmax), i.e. a deterministic stable choice. Behavior differs
from the reference only on exact weight ties between distinct edges.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

# indices of the 16 non-deletion edges within the 25-row alphabet
_NODEL = np.array([s * 5 + t for s in range(4) for t in range(4)])


def _first_step(cols0: np.ndarray):
    """cols0 [N, 25] first-link counts -> source/target node pairs
    (heuristic.py:46-68): two heaviest non-deletion edges; if the second
    weight is 0, both paths start on the heaviest edge."""
    vals = cols0[:, _NODEL]                       # [N, 16]
    e0 = np.argmax(vals, axis=1)
    masked = vals.copy()
    masked[np.arange(len(vals)), e0] = -1
    e1 = np.argmax(masked, axis=1)
    w1 = masked[np.arange(len(vals)), e1]
    dup = w1 <= 0
    e1 = np.where(dup, e0, e1)
    s0, t0 = e0 // 4, e0 % 4
    s1, t1 = e1 // 4, e1 % 4
    return s0, s1, t0, t1


def _follow(colk: np.ndarray, n0: np.ndarray, n1: np.ndarray):
    """colk [N, 25] one link's counts; n0/n1 [N] current nodes (0..3) ->
    next nodes (heuristic.py:18-37): heaviest outgoing edge to {A,C,G,T}
    from each node; when the two paths sit on the same node, its top-2
    outgoing edges."""
    idx = np.arange(len(colk))
    out0 = colk[idx[:, None], n0[:, None] * 5 + np.arange(4)[None, :]]
    out1 = colk[idx[:, None], n1[:, None] * 5 + np.arange(4)[None, :]]
    t0 = np.argmax(out0, axis=1)
    same = n0 == n1
    masked = out0.copy()
    masked[idx, t0] = -np.inf
    t1_same = np.argmax(masked, axis=1)
    t1_diff = np.argmax(out1, axis=1)
    return t0, np.where(same, t1_same, t1_diff)


def two_path_center_nodes(edge_matrix: np.ndarray) -> np.ndarray:
    """edge_matrix [N, 25, P-1] -> [N, 2] the two path nodes at the group
    center (path index P//2)."""
    n, _, links = edge_matrix.shape
    center = (links + 1) // 2
    s0, s1, n0, n1 = _first_step(edge_matrix[:, :, 0])
    c0, c1 = (s0, s1) if center == 0 else (n0, n1)
    for j in range(1, links):
        n0, n1 = _follow(edge_matrix[:, :, j], n0, n1)
        if j + 1 == center:
            c0, c1 = n0, n1
    return np.stack([c0, c1], axis=1)


def _reverse_edges(edge_matrix: np.ndarray) -> np.ndarray:
    """Reverse the walk direction: reverse link order and transpose each
    edge's source/target (heuristic.py:86-92)."""
    s = np.arange(25) // 5
    t = np.arange(25) % 5
    transpose_rows = t * 5 + s
    return edge_matrix[:, transpose_rows, ::-1]


def call_homozygous(edge_matrix: np.ndarray) -> np.ndarray:
    """[N, 25, P-1] -> [N] bool: candidate called homozygous when the
    greedy two-path meets at the center in the forward or reversed
    direction (heuristic.py:93-95)."""
    edge_matrix = np.asarray(edge_matrix, dtype=np.float64)
    if len(edge_matrix) == 0:
        return np.zeros((0,), dtype=bool)
    fwd = two_path_center_nodes(edge_matrix)
    bwd = two_path_center_nodes(_reverse_edges(edge_matrix))
    return (fwd[:, 0] == fwd[:, 1]) | (bwd[:, 0] == bwd[:, 1])


def call_homozygous_pair_route(pair_route: np.ndarray) -> np.ndarray:
    """Pair-route variant (heuristic_pair_route.py:17-61): per column the
    two heaviest source bases each vote their argmax center target;
    homozygous when agreeing columns are at least half. [N, 25, P-1] ->
    [N] bool."""
    pair_route = np.asarray(pair_route, dtype=np.float64)
    if len(pair_route) == 0:
        return np.zeros((0,), dtype=bool)
    n, _, links = pair_route.shape
    rows16 = np.array([s * 5 + t for s in range(4) for t in range(4)])
    v = pair_route[:, rows16, :].reshape(n, 4, 4, links)
    w = v.max(axis=2)                          # [N, 4, links] per-source best
    tgt = v.argmax(axis=2)                     # that edge's center base
    s0 = w.argmax(axis=1)                      # heaviest source per column
    masked = w.copy()
    np.put_along_axis(masked, s0[:, None, :], -np.inf, axis=1)
    s1 = masked.argmax(axis=1)
    a1 = np.take_along_axis(tgt, s0[:, None, :], axis=1)[:, 0, :]
    a2 = np.take_along_axis(tgt, s1[:, None, :], axis=1)[:, 0, :]
    homo_cols = (a1 == a2).sum(axis=1)
    return homo_cols * 2 >= links


def run_heuristic(edge_matrix: np.ndarray,
                  positions: Sequence[str],
                  *, pair_route: bool = False) -> List[str]:
    """Reference Run() core: emit the positions called homozygous. With
    pair_route=True the input is the pair-route matrix and the
    heuristic_pair_route.py voting rule applies."""
    homo = (call_homozygous_pair_route(edge_matrix) if pair_route
            else call_homozygous(edge_matrix))
    return [p for p, h in zip(positions, homo) if h]
