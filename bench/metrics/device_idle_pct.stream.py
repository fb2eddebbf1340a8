"""Share of a stream round in which the device is idle: the device-busy
seconds of a traced round (profiler trace) against the mean length of the
untraced rounds (host clock), since the profiler slows the host's part of
a traced round and not the device's."""
from bench import readers

LAYER = "device"
UNIT = "%"
MOVES = "round_ms"


def read(record):
    return readers.idle_pct_of_rounds(record)
