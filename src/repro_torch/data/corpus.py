"""Synthetic versioned corpus generator (paper §V-A).

Reproduces the paper's evaluation setup: N documents (5,000-8,000 words
each) versioned across V time points with a controlled edit rate, PLUS
machine-checkable ground truth:

  - every edit is logged (doc, position, op, version) — change-detection
    accuracy is scored against this log (paper §V-B3);
  - every document carries FACT paragraphs whose value changes across
    versions ("metric alpha-D7-p3 equals 842 units (revision 2)") —
    temporal queries have exact expected answers per timestamp
    (paper §V-B5: 20 historical queries, 100% accuracy, 0% leakage).

Deterministic via seed; no external data needed.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

_TOPICS = ("security", "billing", "network", "storage", "compliance",
           "deployment", "monitoring", "identity", "backup", "capacity")
_FILLER = ("the system", "operations", "the service", "production",
           "the cluster", "engineering", "the platform", "support")
_VERBS = ("requires", "handles", "processes", "maintains", "validates",
          "schedules", "reports", "archives")
_OBJS = ("incident tickets", "access reviews", "quota changes",
         "audit records", "rotation keys", "change windows",
         "risk assessments", "escalation paths")


@dataclasses.dataclass
class EditLog:
    """Ground truth for one document transition v-1 -> v."""
    doc_id: str
    version: int
    modified: list[int]
    added: list[int]
    deleted: list[int]


@dataclasses.dataclass
class FactSpec:
    """A queryable fact whose value changes at known versions."""
    doc_id: str
    position: int
    name: str                       # e.g. "metric alpha-D7-p3"
    values: list[Optional[int]]     # value per version (None = unchanged)

    def value_at_version(self, v: int) -> int:
        val = None
        for i in range(v + 1):
            if self.values[i] is not None:
                val = self.values[i]
        assert val is not None
        return val


def _sentence(rng: random.Random, topic: str) -> str:
    return (f"{rng.choice(_FILLER)} {rng.choice(_VERBS)} "
            f"{rng.choice(_OBJS)} for {topic} tier {rng.randint(1, 9)}")


def _paragraph(rng: random.Random, topic: str, tag: str,
               n_sentences: int = 5) -> str:
    body = ". ".join(_sentence(rng, topic) for _ in range(n_sentences))
    return f"Section {tag} covering {topic}. {body}."


def _fact_paragraph(fact: FactSpec, version: int) -> str:
    return (f"{fact.name} equals {fact.value_at_version(version)} units "
            f"as recorded in this knowledge base entry.")


@dataclasses.dataclass
class VersionedCorpus:
    n_docs: int
    n_versions: int
    timestamps: list[int]                      # unix micros per version
    versions: list[dict[str, str]]             # [v] -> {doc_id: text}
    edit_logs: list[list[EditLog]]             # [v] -> logs (v>=1)
    facts: list[FactSpec]

    def doc_ids(self) -> list[str]:
        return sorted(self.versions[0])


def generate_corpus(n_docs: int = 100, n_versions: int = 5,
                    paras_per_doc: int = 24, edit_rate: float = 0.12,
                    facts_per_doc: int = 2, seed: int = 0,
                    doc_change_prob: float = 0.9,
                    t0: int = 1_700_000_000_000_000,
                    dt: int = 30 * 24 * 3600 * 1_000_000
                    ) -> VersionedCorpus:
    """Edit model per version transition: each doc changes with
    doc_change_prob; a changed doc gets ~edit_rate of paragraphs
    modified (fact paragraphs included with p=0.5), one added (p=0.3),
    one deleted (p=0.2) — the paper's 10-15% chunk-reprocessing regime,
    with document-level upsert landing at 85-95% (Table II)."""
    rng = random.Random(seed)
    facts: list[FactSpec] = []
    base_docs: dict[str, list[str]] = {}

    for d in range(n_docs):
        doc_id = f"D{d:03d}"
        topic = _TOPICS[d % len(_TOPICS)]
        paras = [_paragraph(rng, topic, f"{doc_id}-p{p}")
                 for p in range(paras_per_doc)]
        taken: set[int] = set()
        for f_i in range(facts_per_doc):
            pos = rng.randrange(paras_per_doc)
            while pos in taken:
                pos = rng.randrange(paras_per_doc)
            taken.add(pos)
            # values[v>0] are filled ONLY when the edit loop actually
            # rewrites the paragraph at version v (text == ground truth)
            values: list[Optional[int]] = [rng.randint(100, 999)] + \
                [None] * (n_versions - 1)
            fact = FactSpec(doc_id, pos, f"metric alpha-{doc_id}-p{pos}",
                            values)
            facts.append(fact)
            paras[pos] = _fact_paragraph(fact, 0)
        base_docs[doc_id] = paras

    versions: list[dict[str, str]] = []
    edit_logs: list[list[EditLog]] = [[]]
    cur = {d: list(p) for d, p in base_docs.items()}
    fact_at = {(f.doc_id, f.position): f for f in facts}
    versions.append({d: "\n\n".join(p) for d, p in cur.items()})

    for v in range(1, n_versions):
        logs = []
        for d in sorted(cur):
            if rng.random() > doc_change_prob:
                logs.append(EditLog(d, v, [], [], []))
                continue
            paras = cur[d]
            topic = _TOPICS[int(d[1:]) % len(_TOPICS)]
            n_mod = max(1, round(edit_rate * len(paras)))
            positions = set(rng.sample(range(len(paras)), k=n_mod))
            # fact paragraphs change with p=0.5 (queryable ground truth)
            for (fd, fpos), fact in fact_at.items():
                if fd == d and rng.random() < 0.5:
                    positions.add(fpos)
            modified = []
            for pos in sorted(positions):
                fact = fact_at.get((d, pos))
                if fact is not None:
                    fact.values[v] = rng.randint(100, 999)
                    paras[pos] = _fact_paragraph(fact, v)
                else:
                    paras[pos] = _paragraph(rng, topic,
                                            f"{d}-p{pos}-rev{v}")
                modified.append(pos)
            added, deleted = [], []
            if rng.random() < 0.3:
                paras.append(_paragraph(rng, topic,
                                        f"{d}-new-v{v}"))
                added.append(len(paras) - 1)
            if rng.random() < 0.2 and len(paras) > facts_per_doc + 2:
                # delete the LAST paragraph (keeps fact positions stable)
                if (d, len(paras) - 1) not in fact_at:
                    paras.pop()
                    deleted.append(len(paras))
                    # a same-version modify of the popped slot is a delete
                    if len(paras) in modified:
                        modified.remove(len(paras))
                    if len(paras) in added:
                        added.remove(len(paras))
                        deleted.pop()           # added-then-deleted: no-op
            logs.append(EditLog(d, v, sorted(modified), added, deleted))
        versions.append({d: "\n\n".join(p) for d, p in cur.items()})
        edit_logs.append(logs)

    return VersionedCorpus(
        n_docs=n_docs, n_versions=n_versions,
        timestamps=[t0 + v * dt for v in range(n_versions)],
        versions=versions, edit_logs=edit_logs, facts=facts)
