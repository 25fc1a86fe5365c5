"""100 x (1 - the device's busy time over the traced frames' wall time)
(%), both read from the trace: the busy union of the GPU events and the
traced frames' span, less the idle time that lies under the host's graph
launches. Under the tracer a launch of the frame's graph takes the host
20-30 ms longer, time in which the device waits on the tracer and not on
the program; the rest of the host's time between replays (the inputs'
copies, the key's choice, the clones, the synchronise) counts as idle."""


def read(record):
    wall = record["window_s"] - record["launch_idle_s"]
    if not record["frames"] or wall <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / wall)
