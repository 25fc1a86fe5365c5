"""GPU self time a frame of the events in the 1preprocess bucket (ms)."""


def read(record):
    return record["buckets_ms"].get("1preprocess")
