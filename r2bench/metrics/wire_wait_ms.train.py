"""Rank 0's host blocked on the gloo wire (``stats["wait_s"]``: each
round's ``work.wait()``, a part of ``wire_ms.train``) a step, in ms; a
program that does not time the wait has none."""


def read(records: dict):
    t = records.get("train")
    if not t or not t["steps"] or "wait_s" not in t["stats"]:
        return None
    return 1e3 * t["stats"]["wait_s"] / t["steps"]
