"""The gradient wire on rank 0 (``stats["wire_s"]``, host staging included)
a step, in ms."""


def read(records: dict):
    t = records.get("train")
    if not t or not t["steps"] or "wire_s" not in t["stats"]:
        return None
    return 1e3 * t["stats"]["wire_s"] / t["steps"]
