"""Ingestion CLI (Layer 5 interface). Runs on the card; pass ``--device
cpu`` to run on the CPU (the kernels' plain versions).

  PYTHONPATH=src python -m repro_torch.launch.ingest --root /tmp/lvl \
      [--device cpu] ingest --doc-id policy-1 --file policy.md [--ts 1700000000000000]
  ... query --text "security policy" [--at 1700000000000000] [-k 5]
  ... stats
  ... history --doc-id policy-1
  ... reconcile
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_ing = sub.add_parser("ingest")
    p_ing.add_argument("--doc-id", required=True)
    p_ing.add_argument("--file", required=True)
    p_ing.add_argument("--ts", type=int, default=None)

    p_q = sub.add_parser("query")
    p_q.add_argument("--text", required=True)
    p_q.add_argument("--at", type=int, default=None)
    p_q.add_argument("-k", type=int, default=5)

    sub.add_parser("stats")
    p_h = sub.add_parser("history")
    p_h.add_argument("--doc-id", required=True)
    sub.add_parser("reconcile")

    args = ap.parse_args(argv)

    from ..core.store import LiveVectorLake
    store = LiveVectorLake(args.root, dim=args.dim, device=args.device)

    if args.cmd == "ingest":
        with open(args.file) as f:
            text = f.read()
        s = store.ingest(args.doc_id, text, ts=args.ts)
        print(json.dumps(vars(s), indent=1))
    elif args.cmd == "query":
        results = store.query(args.text, k=args.k, at=args.at)
        for r in results:
            print(f"[{r.score:+.3f}] ({r.tier}) {r.doc_id}@{r.position} "
                  f"v{r.version}: {r.text[:100]}")
    elif args.cmd == "stats":
        print(json.dumps(store.stats(), indent=1, default=str))
    elif args.cmd == "history":
        for h in store.cold.history(args.doc_id):
            print(json.dumps(h))
    elif args.cmd == "reconcile":
        print(json.dumps(store.reconcile()))
    else:  # pragma: no cover
        sys.exit(2)


if __name__ == "__main__":
    main()
