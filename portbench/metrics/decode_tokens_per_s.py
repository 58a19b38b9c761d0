"""``decode_tokens_per_s``: every output token that reached host memory
in the window (B a step, and B a fresh batch's prefill), over the
window's host seconds."""


def value(rec) -> float:
    return rec["tokens"] / rec["window_s"]
