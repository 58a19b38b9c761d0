"""``round_s``: the window's host seconds over the cloud rounds completed
in it (a closed loop of ``HFLSimulator.run(test, rounds=1)``; in async a
round is M_active edge merges, as ``run`` counts them)."""


def value(rec) -> float:
    return rec["window_s"] / rec["units"]
