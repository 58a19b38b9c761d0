"""``cache_copy_ms.decode``: device milliseconds a decode step spends
copying the scanned stack's ring cache (k, v and slot_pos, cloned once a
step in ``repro_torch/models/transformer.py``): the operations the host
queued inside the program's ``decode.cache_copy`` ranges, over the
slice's ``model.decode_step`` ranges."""
from harness.program import device_per_unit


def read(rec):
    s = device_per_unit(rec, "decode.cache_copy", "model.decode_step")
    return None if s is None else 1e3 * s
