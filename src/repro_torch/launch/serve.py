"""Serving launcher: RAG answers over a LiveVectorLake store with request
batching (Layer 5 interface; the end-to-end entry point). Runs on the
card; pass ``--device cpu`` to run on the CPU (the kernels' plain
versions).

  PYTHONPATH=src python -m repro_torch.launch.serve --root /tmp/lvl \\
      --queries "q1" "q2" [--at TS] [--batch 4] [--device cpu]
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--queries", nargs="+", required=True)
    ap.add_argument("--at", type=int, default=None)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..core.store import LiveVectorLake
    from ..models.transformer import TransformerConfig
    from ..serve.batcher import Batcher
    from ..serve.engine import RAGEngine

    store = LiveVectorLake(args.root, dim=384, device=args.device)
    small_lm = TransformerConfig(
        name="serve-lm", vocab=30_522, d_model=128, n_layers=2, n_heads=4,
        n_kv=2, d_head=32, d_ff=512, act="swiglu")
    engine = RAGEngine(store, small_lm, device=args.device)

    def run_batch(payloads):
        return [engine.answer(q, k=args.k, at=args.at,
                              max_new_tokens=args.max_new_tokens)
                for q in payloads]

    batcher = Batcher(run_batch, max_batch=args.batch)
    reqs = [batcher.submit(q) for q in args.queries]
    batcher.drain()
    for r in reqs:
        res = r.result
        print(f"\n=== {res.query} (at={res.at}) ===")
        for i, hit in enumerate(res.retrieved):
            print(f"  ctx[{i}] ({hit.tier} v{hit.version}) "
                  f"{hit.text[:90]}")
        print(f"  generated token ids: {res.token_ids}")
    print(f"\nbatcher stats: {batcher.stats}")


if __name__ == "__main__":
    main()
