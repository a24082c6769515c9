"""Host milliseconds the stacked loop waits for its next batch
(``TrainingScene.batches()``), the benchmark's own span around the fetch,
mean over the untraced steps."""


def read(r):
    return r.get("batch_ms")
