"""GPU self time a frame of the events outside any graph replay: the
frame's inputs copied in, the outputs' copies out (ms)."""


def read(record):
    return record["buckets_ms"].get("io")
