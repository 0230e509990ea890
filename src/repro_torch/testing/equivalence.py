"""Oracle-equivalence of two result lists: the port's own copy of the
shard planner's ``results_equivalent`` (``repro_torch.shard`` re-exports
it). Ids and order must match wherever scores are separated by more than
float noise; score bits may differ between builds."""
from __future__ import annotations


def results_equivalent(oracle_res, fab_res, oracle_ext=None,
                       rtol: float = 1e-5, atol: float = 1e-7) -> bool:
    """Executable statement of the planner's oracle-equivalence
    guarantee (used by the property tests and the shard_scaling gate):

      - same result count; rank-for-rank scores equal within
        (rtol, atol) — cross-layout float noise only;
      - identical records at identical ranks, EXCEPT that records may
        permute within an iso-score band (ties are unordered on both
        sides) and the band truncated at the k boundary may pick any
        members of the oracle's extended tied cohort (``oracle_ext``:
        the oracle's results at a larger k).

    ``version`` is deliberately excluded from record identity — cold
    commit numbering is shard-local by design.
    """
    import math
    from collections import Counter

    def close(a: float, b: float) -> bool:
        return math.isclose(a, b, rel_tol=rtol, abs_tol=atol)

    def key(r):
        return (r.chunk_id, r.doc_id, r.position, r.valid_from,
                r.valid_to, r.text, r.tier)

    if len(oracle_res) != len(fab_res):
        return False
    if not all(close(ro.score, rf.score)
               for ro, rf in zip(oracle_res, fab_res)):
        return False
    ko = [key(r) for r in oracle_res]
    kf = [key(r) for r in fab_res]
    if ko == kf:
        return True
    co, cf = Counter(ko), Counter(kf)
    if co != cf:
        # membership may differ only inside the tied cohort truncated
        # at the k boundary
        if not oracle_res:
            return False
        last = oracle_res[-1].score
        cohort = {key(r) for r in (oracle_ext or [])
                  if close(r.score, last)}
        if any(k_ not in cohort for k_ in (cf - co)):
            return False
        if any(not close(oracle_res[ko.index(k_)].score, last)
               for k_ in (co - cf)):
            return False
    pos: dict = {}
    for i, k_ in enumerate(ko):
        pos.setdefault(k_, []).append(i)
    for i, k_ in enumerate(kf):
        if i < len(ko) and k_ == ko[i]:
            continue
        js = pos.get(k_)
        if js is None:
            continue                      # boundary extra, checked above
        if not any(close(oracle_res[j].score, fab_res[i].score)
                   for j in js):
            return False                  # displaced across a score gap
    return True


def topk_agree(s_a, i_a, s_b, i_b, score_atol: float = 1e-4,
               gap: float = 1e-5) -> tuple[bool, float, str]:
    """Compare two (Q, k) top-k results (arrays or tensors) of the same
    query block, ``b`` being the reference. They agree when the -inf
    slots are the same slots and hold index -1 on both sides, the finite
    scores are within ``score_atol``, and the ids are equal at every
    slot whose reference score is more than ``gap`` away from both
    neighbours (inside a closer band, float noise may reorder ties).

    ``b`` may hold more columns than ``a``: its next entries are read
    only as the right-hand neighbours of ``a``'s last slot, which can
    then be exempted like any other near-tie. Without them the last slot
    is held to its id whatever the unseen next score.
    Returns (agree, largest finite score difference, reason)."""
    import numpy as np

    def host(x):
        return np.asarray(x.cpu() if hasattr(x, "cpu") else x)

    s_a, i_a, s_b, i_b = (host(x) for x in (s_a, i_a, s_b, i_b))
    k = s_a.shape[1] if s_a.ndim == 2 else 0
    nxt = np.full((s_b.shape[0], 1), -np.inf)
    if s_b.ndim == 2 and s_b.shape[1] > k and i_b.shape == s_b.shape:
        nxt = s_b[:, k:k + 1]
        s_b, i_b = s_b[:, :k], i_b[:, :k]
    if s_a.shape != s_b.shape or i_a.shape != i_b.shape:
        return False, float("inf"), f"shapes {s_a.shape} vs {s_b.shape}"
    fin_a, fin_b = np.isfinite(s_a), np.isfinite(s_b)
    if not np.array_equal(fin_a, fin_b):
        return False, float("inf"), "-inf slots differ"
    if not (np.all(i_a[~fin_a] == -1) and np.all(i_b[~fin_b] == -1)):
        return False, float("inf"), "an empty slot has an index other than -1"
    err = float(np.max(np.abs(s_a[fin_a] - s_b[fin_b]), initial=0.0))
    if err > score_atol:
        return False, err, f"scores differ by {err}"
    if k == 0:
        return True, err, ""
    pad = np.full((s_b.shape[0], 1), np.inf, np.float64)

    def finite(x):
        return np.where(np.isfinite(x), x, -1e30).astype(np.float64)

    sb = finite(s_b)
    left = np.abs(np.diff(np.concatenate([pad, sb], axis=1), axis=1))
    right = np.abs(np.diff(np.concatenate([sb, finite(nxt)], axis=1),
                           axis=1))
    clear = fin_b & (np.minimum(left, right) > gap)
    bad = np.argwhere(clear & (i_a != i_b))
    if len(bad):
        qi, j = (int(x) for x in bad[0])
        return False, err, (
            f"ids differ at a slot clear of ties: query {qi} slot {j}, id "
            f"{i_a[qi, j]} vs reference {i_b[qi, j]} (score "
            f"{s_b[qi, j]!r}, gaps {left[qi, j]!r} and {right[qi, j]!r})")
    return True, err, ""


def rounding_agree(got, want, rel: float, slack: float = 1e-4
                   ) -> tuple[bool, float]:
    """Hold ``got`` to the reference ``want`` (tensors of one shape)
    element by element, each within ``rel * |want|`` plus ``slack``
    times the largest |want| of its row (the last axis). For outputs
    that both sides compute in fp32 and round to bf16, ``rel = 2**-7``
    is one rounding step (bf16 keeps 8 significant bits), and the slack
    covers the fp32 sums' differences where a value is near 0; for fp32
    outputs, ``rel`` is the relative error allowed. A limit scaled to
    each value catches errors that a fixed absolute limit would miss
    where the values are small. Returns (agree, largest ratio of an
    error to its limit)."""
    import torch

    g, w = got.float(), want.float()
    if g.shape != w.shape:
        return False, float("inf")
    lim = rel * w.abs() + slack * w.abs().amax(-1, keepdim=True)
    diff = (g - w).abs()
    ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / lim)
    worst = float(ratio.max()) if ratio.numel() else 0.0
    return worst <= 1.0, worst


def partials_agree(got, want, rel: float = 1e-4) -> tuple[bool, float, str]:
    """Hold split-softmax partials ``got = (m, l, acc)`` (m, l: (..., ns),
    acc: (..., ns, D), fp32) to the reference ``want``: the empty splits
    (m = -inf) are the same and hold l = 0 and acc = 0; elsewhere m is
    within ``rel * max(1, |m|)``, l within ``rel * l`` and acc within
    ``rel`` of each value plus ``rel`` of its split's largest |acc|.
    Returns (agree, largest ratio of an error to its limit, reason)."""
    import torch

    (gm, gl, ga), (wm, wl, wa) = got, want
    if gm.shape != wm.shape or gl.shape != wl.shape or ga.shape != wa.shape:
        return False, float("inf"), "shapes differ"
    empty = torch.isneginf(wm)
    if not torch.equal(torch.isneginf(gm), empty):
        return False, float("inf"), "the empty splits differ"
    if not (bool((gl[empty] == 0).all()) and bool((ga[empty] == 0).all())):
        return False, float("inf"), "an empty split has l or acc != 0"
    live = ~empty
    worst = 0.0
    for name, diff, lim in (
            ("m", (gm - wm)[live].abs(), rel * wm[live].abs().clamp_min(1)),
            ("l", (gl - wl)[live].abs(), rel * wl[live])):
        r = float((diff / lim).max()) if diff.numel() else 0.0
        if not r <= 1.0:
            return False, r, f"{name} differs by {r:.3g} x its limit"
        worst = max(worst, r)
    ok, r = rounding_agree(ga, wa, rel, rel)
    if not ok:
        return False, r, f"acc differs by {r:.3g} x its limit"
    return True, max(worst, r), ""


def grads_agree(got, want, bf16: bool, envelope=None) -> tuple[bool, float]:
    """Hold a backward kernel's gradient ``got`` to its plain version's
    ``want`` (tensors of one shape, both summed in fp32 from the same
    inputs). fp32: within 1e-4 of the tensor's largest |value| (other sum
    orders). bf16: each element within one rounding step (2**-7) of its
    value plus 1e-4 of its row's largest (``rounding_agree``), the row's
    largest floored at 1e-2 of the tensor's: a row whose exact gradient
    is 0 (attention's first causal row sees one key, and its
    dS = P (dP - Delta) cancels) holds only the two sums' rounding noise,
    with no scale of its own. ``envelope`` (bf16 only; of the same shape)
    is added to each element's limit where the two sides read inputs
    rounded apart, as ``flash_attention.plain.o_rounding_bound`` gives for
    two forwards' outputs. Returns (agree, largest ratio of an error to
    its limit)."""
    import torch

    g, w = got.float(), want.float()
    if g.shape != w.shape:
        return False, float("inf")
    top = float(w.abs().max()) if w.numel() else 0.0
    diff = (g - w).abs()
    if not bf16:
        err = float(diff.max()) if diff.numel() else 0.0
        worst = 0.0 if err == 0 else (err / (1e-4 * top) if top > 0
                                      else float("inf"))
        return worst <= 1.0, worst
    row = torch.clamp(w.abs().amax(-1, keepdim=True), min=1e-2 * top)
    lim = 2 ** -7 * w.abs() + 1e-4 * row
    if envelope is not None:
        lim = lim + envelope.float()
    ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / lim)
    worst = float(ratio.max()) if ratio.numel() else 0.0
    return worst <= 1.0, worst


def lse_agree(got, want, rel: float = 1e-5) -> tuple[bool, float]:
    """Hold a row logsumexp ``got`` (fp32) to ``want`` from another
    computation of it: -inf at the same rows (rows that see no key),
    elsewhere within ``rel`` of max(1, |want|) (both sum exp of the same
    scaled logits in fp32, in other orders, one of them in base 2).
    Returns (agree, largest ratio of an error to its limit)."""
    import torch

    g, w = got.float(), want.float()
    if g.shape != w.shape:
        return False, float("inf")
    empty = torch.isneginf(w)
    if not torch.equal(torch.isneginf(g), empty):
        return False, float("inf")
    g, w = g[~empty], w[~empty]
    if not bool(torch.isfinite(g).all()):
        return False, float("inf")
    lim = rel * torch.clamp(w.abs(), min=1.0)
    worst = float(((g - w).abs() / lim).max()) if g.numel() else 0.0
    return worst <= 1.0, worst
