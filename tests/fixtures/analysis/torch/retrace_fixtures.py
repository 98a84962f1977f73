"""Operand-side retrace fixtures for the port's key-flow check.

``baked`` never reads ``sc["baked"]``; ``all_live`` reads every key;
``steered`` reads ``sc["gate"]`` only to branch on it (consumed);
``rebuilt`` copies the dict, as ``state.epoch_rows`` does, and reads one
key of the copy (the copy consumes nothing by itself).  ``epoch_baked``
is ``tests/fixtures/analysis/epoch_baked.py``'s slip: it reads epoch
0's row with a static index and never the ``epoch_bounds`` vector.
"""


def baked(sc):
    return sc["used"] * 2.0


def all_live(sc):
    return sc["a"] + sc["b"]


def steered(sc):
    return sc["x"] * 2.0 if float(sc["gate"]) > 0.0 else sc["x"]


def rebuilt(sc):
    rows = {k: v for k, v in sc.items()}
    return rows["used"] * 1.0


def epoch_baked(sc):
    return sc["quota"][0] * 2.0 + sc["crash_at"]
