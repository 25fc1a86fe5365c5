"""GPU self time a frame of the events in the holefill bucket (ms)."""


def read(record):
    return record["buckets_ms"].get("holefill")
