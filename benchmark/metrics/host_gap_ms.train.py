"""host_gap_ms.train: mean host milliseconds between the return of one
train-step call and the next call in the window: `fit()`'s loop body and
the wait on the `PrefetchLoader` (the Training loop layer, timed by the
benchmark's shim passed as `fit(train_step=...)`)."""


def read(rec):
    gaps = rec["host_gaps"]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
