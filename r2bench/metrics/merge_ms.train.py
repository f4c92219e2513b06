"""The schedule's merges on rank 0 (``stats["merge_s"]``) a step, in ms."""


def read(records: dict):
    t = records.get("train")
    if not t or not t["steps"] or "merge_s" not in t["stats"]:
        return None
    return 1e3 * t["stats"]["merge_s"] / t["steps"]
