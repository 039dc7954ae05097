"""Host time per step inside ``MinedDataset.batches`` (SimANS sampling
and joint packing), from the benchmark's span around each ``next()`` in
the window: the spans' sum over the steps. Moves ``train_step_ms``."""


def read(view):
    spans = view.spans.seconds.get("data.batch")
    steps = view.work.get("steps")
    if not spans or not steps:
        return None
    return 1e3 * sum(spans) / sum(steps.values())
