"""Rank 0's copies between the card and the pinned host buffers of the
gloo wire (``stats["stage_s"]``, a part of ``wire_ms.train``) a step, in
ms."""


def read(records: dict):
    t = records.get("train")
    if not t or not t["steps"] or "stage_s" not in t["stats"]:
        return None
    return 1e3 * t["stats"]["stage_s"] / t["steps"]
