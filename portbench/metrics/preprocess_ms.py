"""preprocess_ms: mean host time of `preprocess.from_audio` a request,
from the span the driver opens around it (a synchronize at each end)"""


def read(reading):
    spans = reading.spans.get('preprocess')
    return 1e3 * sum(spans) / len(spans) if spans else None
