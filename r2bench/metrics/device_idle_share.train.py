"""The share of the window in which no operation of any rank ran on the
card, in %: 1 - (the union of the four ranks' device intervals) / window."""


def read(records: dict):
    t = records.get("train")
    if not t or not t.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["trace_window_s"])
