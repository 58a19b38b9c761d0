"""``itl_p95_ms``: the 95th percentile of every inter-token gap in the
window: host time between one step's B tokens reaching host memory and
the next's (a fresh batch's prefill is the gap before its first tokens)."""
from harness.stats import percentile


def value(rec) -> float:
    return 1e3 * percentile(rec["gaps_s"], 95)
