"""Oracle-equivalence of two result lists: the port's own copy of the
shard planner's ``results_equivalent`` (the shard fabric itself is not
ported yet). Ids and order must match wherever scores are separated by
more than float noise; score bits may differ between builds."""
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
    Returns (agree, largest finite score difference, reason)."""
    import numpy as np

    def host(x):
        return np.asarray(x.cpu() if hasattr(x, "cpu") else x)

    s_a, i_a, s_b, i_b = (host(x) for x in (s_a, i_a, s_b, i_b))
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
    if s_b.shape[1] == 0:
        return True, err, ""
    pad = np.full((s_b.shape[0], 1), np.inf, np.float64)
    sb = np.where(fin_b, s_b, -1e30).astype(np.float64)
    left = np.abs(np.diff(np.concatenate([pad, sb], axis=1), axis=1))
    right = np.abs(np.diff(np.concatenate([sb, -pad], axis=1), axis=1))
    clear = fin_b & (np.minimum(left, right) > gap)
    if not np.array_equal(i_a[clear], i_b[clear]):
        return False, err, "ids differ at a slot clear of ties"
    return True, err, ""
