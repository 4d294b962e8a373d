"""Device ms a traced frame of stage D (ops/sorting.py): torch.sort's
radix-sort kernels (cub's DeviceRadixSort and the index fill) and the
three gathers of the sorted attribute words (index_elementwise_kernel).
The key's packing into an int64 and back counts with stage.plain_ms."""

NAMES = r"DeviceRadixSort|fill_reverse_indices_kernel|index_elementwise_kernel"


def read(r):
    if r.stretch is None or not r.traced:
        return None
    ms = r.stretch.records(NAMES)
    return sum(ms) / len(r.traced) if ms else None
