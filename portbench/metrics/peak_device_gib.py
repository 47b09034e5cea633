"""peak_device_gib: the caching allocator's peak over set-up and window
(`torch.cuda.max_memory_allocated`), in GiB."""


def read(records):
    if not records.get("peak_bytes"):
        return None
    return records["peak_bytes"] / 2**30
