"""Mean wall ms of the temporal engine's fused scan a batch (span
``fused_temporal``: the upload of the queries and instants, the
``temporal_window_topk`` launch, the merge and the copy back, with the
syncs the traced run adds)."""


def read(run):
    return run.per_batch("fused_temporal")
