"""Share (%) of the tiles' window steps that did work: every row of a
block runs the block's most arm steps (kmax); a row's step does work
while the row has an arm left.  The port's counters
``tiles.active_window_steps`` over ``tiles.window_steps``, summed over
the window's polishes (from the host's arm counts; no device read)."""
from polishbench.program_spans import counted


def read(t):
    steps = counted(t, "tiles.window_steps")
    if not steps:
        return None
    return 100.0 * counted(t, "tiles.active_window_steps") / steps
