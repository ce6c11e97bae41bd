"""synthesize_ms: mean host time of a synthesis call a request
(`synthesize.from_features` or `from_features_batched`), from the span
the driver opens around it (a synchronize at each end)"""


def read(reading):
    spans = reading.spans.get('synthesize')
    return 1e3 * sum(spans) / len(spans) if spans else None
