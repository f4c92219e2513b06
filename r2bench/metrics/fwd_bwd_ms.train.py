"""Forward and backward of rank 0's step (``stats["fwd_bwd_s"]``), the
window's total over its steps, in ms."""


def read(records: dict):
    t = records.get("train")
    if not t or not t["steps"] or "fwd_bwd_s" not in t["stats"]:
        return None
    return 1e3 * t["stats"]["fwd_bwd_s"] / t["steps"]
