"""GraphSAGE-style fanout neighbor sampler (minibatch_lg cell).

Host-side (numpy) sampling over a CSR adjacency; emits PADDED fixed-shape
subgraphs so the jitted train step sees static shapes (TPU requirement):
seeds -> fanout[0] neighbors -> fanout[1] neighbors..., edges point
child -> parent (message flow toward the seeds). Padding uses edge
(0, 0) with distance > cutoff, which the SchNet cosine cutoff zeroes —
padded edges carry exactly zero message weight.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SampledSubgraph:
    node_ids: np.ndarray       # (n_pad,) original node ids (-1 = pad)
    edge_index: np.ndarray     # (2, e_pad) local indices [src, dst]
    edge_dist: np.ndarray      # (e_pad,) padded edges get dist=inf-ish
    seed_mask: np.ndarray      # (n_pad,) True for seed nodes
    n_real_nodes: int
    n_real_edges: int


def make_csr(n_nodes: int, edges: np.ndarray) -> tuple[np.ndarray,
                                                       np.ndarray]:
    """edges: (2, E) src->dst. Returns CSR over OUT-neighbors of src."""
    order = np.argsort(edges[0], kind="stable")
    sorted_src = edges[0][order]
    indices = edges[1][order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, sorted_src + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, indices


def sample_subgraph(indptr: np.ndarray, indices: np.ndarray,
                    seeds: np.ndarray, fanouts: tuple[int, ...],
                    rng: np.random.Generator, cutoff: float = 10.0,
                    edge_dist_fn=None) -> SampledSubgraph:
    n_seeds = len(seeds)
    # padded layer sizes: seeds, seeds*f0, seeds*f0*f1, ...
    layer_pad = [n_seeds]
    for f in fanouts:
        layer_pad.append(layer_pad[-1] * f)
    n_pad = sum(layer_pad)
    e_pad = sum(layer_pad[1:])

    node_ids = np.full(n_pad, -1, np.int64)
    edge_src = np.zeros(e_pad, np.int64)
    edge_dst = np.zeros(e_pad, np.int64)
    edge_valid = np.zeros(e_pad, bool)

    node_ids[:n_seeds] = seeds
    frontier = [(i, s) for i, s in enumerate(seeds)]   # (local idx, global)
    node_cursor, edge_cursor = n_seeds, 0
    n_real_edges = 0

    for depth, f in enumerate(fanouts):
        next_frontier = []
        layer_start_node = node_cursor
        for local_parent, gid in frontier:
            nbrs = indices[indptr[gid]: indptr[gid + 1]]
            if len(nbrs) > 0:
                take = rng.choice(nbrs, size=min(f, len(nbrs)),
                                  replace=False)
            else:
                take = np.empty(0, np.int64)
            for child_gid in take:
                node_ids[node_cursor] = child_gid
                edge_src[edge_cursor] = node_cursor
                edge_dst[edge_cursor] = local_parent
                edge_valid[edge_cursor] = True
                next_frontier.append((node_cursor, int(child_gid)))
                node_cursor += 1
                edge_cursor += 1
                n_real_edges += 1
            # skip padding space for unsampled neighbors
            pad_skip = f - len(take)
            node_cursor += pad_skip
            edge_cursor += pad_skip
        # ensure cursors land on the layer boundary
        node_cursor = layer_start_node + layer_pad[depth + 1]
        edge_cursor = sum(layer_pad[1: depth + 2])
        frontier = next_frontier

    if edge_dist_fn is not None:
        dist = edge_dist_fn(edge_src, edge_dst).astype(np.float32)
    else:
        dist = rng.random(e_pad).astype(np.float32) * (0.9 * cutoff)
    # padded edges: distance beyond cutoff => cosine cutoff kills them
    dist = np.where(edge_valid, dist, np.float32(cutoff * 10))

    seed_mask = np.zeros(n_pad, bool)
    seed_mask[:n_seeds] = True
    return SampledSubgraph(
        node_ids=node_ids,
        edge_index=np.stack([edge_src, edge_dst]).astype(np.int32),
        edge_dist=dist, seed_mask=seed_mask,
        n_real_nodes=int((node_ids >= 0).sum()),
        n_real_edges=n_real_edges)
