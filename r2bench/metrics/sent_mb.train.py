"""The bytes rank 0 sends in the rounds of the gradient programs
(``stats["sent_bytes"]``) a step, in MB (1e6 bytes)."""


def read(records: dict):
    t = records.get("train")
    if not t or not t["steps"] or "sent_bytes" not in t["stats"]:
        return None
    return t["stats"]["sent_bytes"] / 1e6 / t["steps"]
