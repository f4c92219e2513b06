"""Wall time on rank 0 of the step that takes the failure, from the
injection (detection, the switch to the degraded step) to that step's end,
in ms; only a cell with a failure has it."""


def read(records: dict):
    t = records.get("train")
    if not t or t.get("failover_s") is None:
        return None
    return 1e3 * t["failover_s"]
