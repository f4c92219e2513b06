"""AdamW's update on rank 0 (``stats["opt_s"]``) a step, in ms."""


def read(records: dict):
    t = records.get("train")
    if not t or not t["steps"] or "opt_s" not in t["stats"]:
        return None
    return 1e3 * t["stats"]["opt_s"] / t["steps"]
