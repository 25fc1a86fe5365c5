"""GPU self time a frame of the events in the "3recon: sweep" bucket (ms)."""


def read(record):
    return record["buckets_ms"].get("3recon: sweep")
