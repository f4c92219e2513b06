"""The share of the window in which no operation ran on the card, in %."""


def read(records: dict):
    s = records.get("serve")
    if not s or not s.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["trace_window_s"])
