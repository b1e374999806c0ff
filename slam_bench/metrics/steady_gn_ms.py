"""The device time of the tracker's Gauss-Newton loops per steady-frame
graph replay: the seconds of every scale's WHILE node ("steady frame:
gn/scale<s> [graph]", the program's device stamps at each node in its
parent graph, the bodies' runs included) over the replays ("steady frame
[graph]"), in ms. The duels and the final cost, outside the WHILE nodes,
are not in it. A program without the stamps gives nothing to read."""

import re

_SCALE = re.compile(r"steady frame: gn/scale\d+ \[graph\]")


def read(record):
    timers = record["timing_s"]
    replays = timers.get("steady frame [graph]", (0, 0.0))[0]
    loops = [seconds for name, (_, seconds) in timers.items() if _SCALE.fullmatch(name)]
    if not replays or not loops:
        return None
    return 1e3 * sum(loops) / replays
