"""encode_ms.eval: the benchmark's span around the task's encode_images,
synchronized at both ends, per batch of the traced run's window (the
profiled batches left out), in ms."""


def read(rec):
    spans = rec.window.get("span_s", {}).get("encode")
    return 1e3 * sum(spans) / len(spans) if spans else None
