"""SchNet (arXiv:1706.08566): continuous-filter convolutions over
molecular / generic graphs (repro's ``models/schnet.py`` in PyTorch).

Message passing goes through ``kernels/segment_sum``: every scatter of
repro's model (the cfconv's ``jax.ops.segment_sum`` over edges, the
energy readout's over graphs, and the gradient of the atom embedding's
``jnp.take``) is ``gather_segment_sum``, which sums each output row in a
fixed order with no atomics, so a step on the card repeats bit for bit.
The rest is dense products (``torch.matmul``).

The edges are sorted by dst once a forward (``edge_chunks``) and cut into
chunks of at most ``edge_chunk`` edges. Each interaction runs its filter
network (rbf -> dense -> ssp -> dense -> cosine cutoff) and the
aggregation chunk by chunk under ``torch.utils.checkpoint``, each chunk
adding its sums into its own rows of the aggregate (the dst range its
edges reach), in chunk order: neither an (E, n_rbf) nor
an (E, d) tensor ever exists for more than one chunk, which is what lets
ogbn-products (61,859,328 padded edges; its rbf alone would be 74.2 GB)
train on one card.

Two input regimes, as repro's:
  - molecules: atom numbers (int) -> embedding table; energy readout with
    per-graph pooling;
  - featureful graphs (cora / ogbn-products shapes): node features ->
    linear projection; node-classification readout.

Params are repro's tree: ``interactions`` holds each leaf stacked on a
leading (n_interactions, ...) axis (repro's ``jax.vmap(inter)``), and the
interactions run as a loop over its ``unbind(0)`` (repro's ``lax.scan``,
and its unrolled branch alike).

On a mesh (``mesh=``, with the batch's executed ``specs``: repro's
``gnn_batch_specs``) a rank holds a block of the edges (split over every
axis) and a block of the node rows (``node_feat`` or ``atom_z``,
``labels``, ``graph_ids``, split over the data-parallel axes); params
are replicated. The rank projects or embeds its node rows and
all-gathers them over the data axes, so the node state is whole on every
rank; each interaction sums the rank's edges (sorted and chunked as on
one card) into a whole (N, d) partial aggregate, and one all-reduce over
every axis makes it the aggregate. The readouts take the rank's node
rows: the per-graph energies and the masked cross-entropy's sums are
all-reduced over the data axes, so every rank returns the whole loss.
Each rank differentiates its share of it (``train/train_loop``: the loss
over the world size): the collectives' backwards sum the ranks'
cotangents, so that each rank's gradient of a leaf is its part of the
one-card gradient, and ``train_loop.reduce_grads`` sums the parts. On
one rank every collective is a copy: the step is the no-mesh step bit
for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.common import resolve_device, seeded_generator
from ..kernels.segment_sum import EdgePlan, gather_segment_sum, take
from .layers import activation, dense_init

_ssp = activation("ssp")

EDGE_CHUNK = 1 << 22      # edges a chunk of the filter network, at most
_LAYER_KEYS = ("filt_w1", "filt_w2", "in2f", "f2out", "atom_w", "atom_b")


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_atom_types: int = 100
    d_feat: Optional[int] = None      # featureful-graph input width
    n_classes: Optional[int] = None   # node classification head
    dtype: torch.dtype = torch.float32
    unroll_layers: bool = False       # repro's roofline probes; one loop here

    def n_params(self) -> int:
        d, r = self.d_hidden, self.n_rbf
        per = (r * d + d * d) + 2 * d * d + d * d        # filter + in2f/f2out + atomwise
        head = d * (d // 2) + (d // 2) * (self.n_classes or 1)
        inp = (self.d_feat or self.n_atom_types) * d
        return inp + self.n_interactions * per + head


@torch.no_grad()
def init_params(cfg: SchNetConfig, seed: int = 0, device=None) -> dict:
    """Seeded params in repro's tree (a train tree: dicts of leaf
    tensors), on ``device`` (None = the card)."""
    device = resolve_device(device)
    gen = seeded_generator(seed, device)
    d, r, dt = cfg.d_hidden, cfg.n_rbf, cfg.dtype

    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, dt, device=device)

    layers = [{"filt_w1": dense(r, d), "filt_w2": dense(d, d),
               "in2f": dense(d, d), "f2out": dense(d, d),
               "atom_w": dense(d, d),
               "atom_b": torch.zeros((d,), dtype=dt, device=device)}
              for _ in range(cfg.n_interactions)]
    p = {"interactions": {k: torch.stack([lp[k] for lp in layers])
                          for k in _LAYER_KEYS}}
    if cfg.d_feat:
        p["input_proj"] = dense(cfg.d_feat, d)
    else:
        p["atom_embed"] = (torch.randn((cfg.n_atom_types, d), generator=gen,
                                       device=device) * 0.1).to(dt)
    p["head_w1"] = dense(d, d // 2)
    p["head_w2"] = dense(d // 2, cfg.n_classes or 1)
    return p


def rbf_expand(dist: torch.Tensor, cfg: SchNetConfig) -> torch.Tensor:
    """Gaussian radial basis: (E,) -> (E, n_rbf), computed in place on one
    (E, n_rbf) buffer."""
    mu = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, device=dist.device)
    delta = cfg.cutoff / cfg.n_rbf
    gamma = 1.0 / (2.0 * delta ** 2)
    r = dist[:, None] - mu[None, :]
    return r.square_().mul_(-gamma).exp_()


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    c = 0.5 * (torch.cos(math.pi * dist / cutoff) + 1.0)
    return torch.where(dist < cutoff, c, 0.0)


def edge_chunks(edge_index: torch.Tensor, n_nodes: int,
                edge_chunk: int = EDGE_CHUNK) -> list:
    """The edges of a batch in chunks of at most ``edge_chunk``, taken
    from their order sorted stably by dst: a list of (perm, lo, plan),
    perm the chunk's edge ids (None for a batch of one chunk: all edges
    in their own order), lo the first node its edges reach and plan its
    ``EdgePlan`` from the n_nodes rows of h into the rows lo, ...,
    lo + plan.n_out - 1 (its dst less lo, in perm's order). A chunk whose
    edges are all dropped (dst outside [0, n_nodes)) gets the one row
    n_nodes - 1 and adds nothing there. Made once a forward and shared
    by every interaction and its backward."""
    src, dst = edge_index[0], edge_index[1]
    e = src.shape[0]
    if e <= edge_chunk:
        return [(None, 0, EdgePlan(src, dst, n_nodes, n_nodes))]
    key = dst.long()
    key = torch.where((key >= 0) & (key < n_nodes), key, n_nodes)
    sorted_key, perm = torch.sort(key, stable=True)
    kept = int((key < n_nodes).sum())
    starts = range(0, e, edge_chunk)
    ends = [max(min(a + edge_chunk, kept) - 1, a) for a in starts]
    at = torch.tensor([*starts, *ends], device=key.device)
    rows = sorted_key[at].clamp(max=n_nodes - 1).tolist()
    out = []
    for i, a in enumerate(starts):
        p = perm[a:a + edge_chunk]
        lo, hi = rows[i], rows[len(starts) + i]
        out.append((p, lo, EdgePlan(src[p], dst[p].long() - lo, n_nodes,
                                    hi - lo + 1)))
    return out


def _cfconv(w1, w2, h, dist, plan, cfg):
    """One chunk's filters and their messages summed into the chunk's
    rows: (plan.n_out, d)."""
    w = _ssp(rbf_expand(dist, cfg) @ w1) @ w2                # (E_c, d)
    w = w * cosine_cutoff(dist, cfg.cutoff)[:, None]
    return gather_segment_sum(h, None, None, plan.n_out, w, plan=plan)


class _AddRows(torch.autograd.Function):
    """``agg[lo:lo + len(part)] += part`` in place. The gradient passes to
    agg as it is and to part as its rows, with no copy (autograd's own
    in-place add on a slice copies the whole gradient each time)."""

    @staticmethod
    def forward(ctx, agg, part, lo):
        ctx.rows = (lo, part.shape[0])
        ctx.mark_dirty(agg)
        agg[lo:lo + part.shape[0]] += part
        return agg

    @staticmethod
    def backward(ctx, g):
        lo, n = ctx.rows
        return g, g[lo:lo + n], None


def _interaction(lp, x, chunks, dists, cfg: SchNetConfig, place):
    """One cfconv + atomwise update. x: (N, d). The chunks add into their
    rows of the aggregate in chunk order; on a mesh the ranks' partial
    aggregates are then summed over the axes that split the edges."""
    h = x @ lp["in2f"]                                       # (N, d)
    agg = torch.zeros_like(h)
    for (_, lo, plan), dist in zip(chunks, dists):
        part = checkpoint(_cfconv, lp["filt_w1"], lp["filt_w2"], h, dist,
                          plan, cfg, use_reentrant=False,
                          preserve_rng_state=False)
        agg = _AddRows.apply(agg, part, lo)
    agg = place.sum(agg, place.edges)
    agg = agg @ lp["f2out"]
    v = _ssp(agg @ lp["atom_w"] + lp["atom_b"])
    return x + v


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The atom embedding: ``jnp.take(table, ids, axis=0)``, its gradient
    through ``gather_segment_sum`` (``kernels/segment_sum.take``)."""
    return take(table, ids)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one rank's graph batch lies: the mesh (None: one card), the
    axes its edges are split over and those its node rows are split over
    (each () where the batch spec leaves them whole)."""
    mesh: object = None
    edges: tuple = ()
    nodes: tuple = ()

    @classmethod
    def of(cls, mesh, specs: Optional[dict]) -> "Placement":
        """The placement of a batch under its executed ``specs``
        (``launch/sharding.gnn_batch_specs``) on ``mesh``."""
        if mesh is None:
            return cls()
        from ..launch.sharding import _axes

        node = next(k for k in ("node_feat", "atom_z") if k in specs)
        return cls(mesh, _axes(specs["edge_dist"][0]),
                   _axes(specs[node][0]))

    def sum(self, t: torch.Tensor, axes: tuple) -> torch.Tensor:
        """``t`` summed over the ranks of ``axes`` (none: ``t``)."""
        if not axes:
            return t
        from ..launch.collectives import all_reduce_sum
        return all_reduce_sum(t, self.mesh, axes)

    def gather_nodes(self, t: torch.Tensor) -> torch.Tensor:
        """The whole node rows from each rank's block of them."""
        if not self.nodes:
            return t
        from ..launch.collectives import all_gather
        return all_gather(t, self.mesh, self.nodes, dim=0)

    def own_nodes(self, t: torch.Tensor, n_local: int) -> torch.Tensor:
        """This rank's block of ``n_local`` rows of the whole node rows
        ``t``."""
        if not self.nodes:
            return t
        from ..launch.mesh import coordinate

        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        coord, block = coordinate(self.mesh), 0
        for a in self.nodes:
            block = block * sizes[a] + coord[a]
        return t.narrow(0, block * n_local, n_local)


def forward(params, cfg: SchNetConfig, *, edge_index, edge_dist,
            node_feat=None, atom_z=None, edge_chunk: int = EDGE_CHUNK,
            mesh=None, specs: Optional[dict] = None):
    """edge_index: (2, E) int32 [src, dst]; edge_dist: (E,) f32.
    Returns per-node hidden (N, d), whole: on a ``mesh`` on every rank,
    from the rank's blocks of the edges and node rows (where ``specs``,
    the batch's executed specs, put them: ``Placement.of``).
    ``edge_chunk``: edges a chunk of the filter network (the sums differ
    from one chunk's only at rows whose edges straddle a chunk boundary,
    by rounding). An atom number reads its embedding row as
    ``jnp.take`` (``kernels/segment_sum.take``)."""
    place = Placement.of(mesh, specs)
    if cfg.d_feat:
        x = node_feat @ params["input_proj"]
    else:
        x = embed(params["atom_embed"], atom_z)
    x = place.gather_nodes(x)
    n_nodes = x.shape[0]
    chunks = edge_chunks(edge_index, n_nodes, edge_chunk)
    dists = [edge_dist if p is None else edge_dist[p]
             for p, _, _ in chunks]
    inter = params["interactions"]
    for vals in zip(*[inter[k].unbind(0) for k in _LAYER_KEYS]):
        x = _interaction(dict(zip(_LAYER_KEYS, vals)), x, chunks, dists,
                         cfg, place)
    return x


def readout_energy(params, hidden, graph_ids, n_graphs: int,
                   place: Placement = Placement()):
    """Per-graph energy: atomwise MLP -> per-graph sum (a graph id outside
    [0, n_graphs) is dropped, as repro's ``segment_sum`` drops it). On a
    mesh, of the rank's node rows (``graph_ids`` its block), summed over
    the data axes."""
    hidden = place.own_nodes(hidden, graph_ids.shape[0])
    e = _ssp(hidden @ params["head_w1"]) @ params["head_w2"]     # (N, 1)
    src = torch.arange(e.shape[0], device=e.device)
    out = gather_segment_sum(e[:, :1].contiguous(), src, graph_ids,
                             n_graphs)[:, 0]
    return place.sum(out, place.nodes)


def readout_node_logits(params, hidden):
    return _ssp(hidden @ params["head_w1"]) @ params["head_w2"]  # (N, C)


def energy_loss(params, cfg, batch, edge_chunk: int = EDGE_CHUNK,
                mesh=None, specs: Optional[dict] = None):
    """The mean squared error of the per-graph energies. On ``mesh`` (the
    batch this rank's blocks under its executed ``specs``) the whole
    loss, on every rank."""
    place = Placement.of(mesh, specs)
    h = forward(params, cfg, edge_index=batch["edge_index"],
                edge_dist=batch["edge_dist"], atom_z=batch.get("atom_z"),
                node_feat=batch.get("node_feat"), edge_chunk=edge_chunk,
                mesh=mesh, specs=specs)
    pred = readout_energy(params, h, batch["graph_ids"], batch["n_graphs"],
                          place)
    return torch.mean(torch.square(pred - batch["energy"]))


def node_class_loss(params, cfg, batch, edge_chunk: int = EDGE_CHUNK,
                    mesh=None, specs: Optional[dict] = None):
    """Masked cross-entropy of the node logits: labels of -1 (off the
    seeds of a sampled batch) count for nothing. The gold logit is picked
    by a comparison, not a gather, so its gradient scatters nothing. On
    ``mesh`` (``specs`` as ``energy_loss``'s) the rank's label rows give
    the masked sums, summed over the data axes: the whole loss, on every
    rank."""
    place = Placement.of(mesh, specs)
    h = forward(params, cfg, edge_index=batch["edge_index"],
                edge_dist=batch["edge_dist"], node_feat=batch["node_feat"],
                edge_chunk=edge_chunk, mesh=mesh, specs=specs)
    h = place.own_nodes(h, batch["labels"].shape[0])
    logits = readout_node_logits(params, h).float()
    labels = batch["labels"]
    logz = torch.logsumexp(logits, dim=-1)
    classes = torch.arange(logits.shape[1], device=logits.device)
    pick = classes[None, :] == torch.clamp(labels, min=0)[:, None].long()
    gold = torch.where(pick, logits, 0.0).sum(-1)
    mask = (labels >= 0).float()
    return place.sum(((logz - gold) * mask).sum(), place.nodes) / \
        torch.clamp(place.sum(mask.sum(), place.nodes), min=1.0)
