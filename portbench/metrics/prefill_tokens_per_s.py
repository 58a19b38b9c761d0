"""``prefill_tokens_per_s``: every prompt token prefilled in the window,
each request through its first token in host memory, over the window's
host seconds."""


def value(rec) -> float:
    return rec["tokens"] / rec["window_s"]
