"""``chunk_combine``'s share of its roofline on rank 0, in %: the bound of
every merge in the window (``formulas.chunk_combine_cost`` of the shapes and
masks the op was called with, bytes at 3.35 TB/s) over the merge kernels'
device time in the profiler's trace."""


def read(records: dict):
    m = (records.get("train") or {}).get("merge")
    if not m or m["device_s"] <= 0:
        return None
    return 100.0 * m["bound_s"] / m["device_s"]
