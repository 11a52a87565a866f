"""peak_device_gb: `torch.cuda.max_memory_allocated()` over the untraced
window, reset at its start, in GB (1e9 bytes)."""


def read(rec):
    peak = rec["window"].get("peak_bytes")
    return None if peak is None else peak / 1e9
