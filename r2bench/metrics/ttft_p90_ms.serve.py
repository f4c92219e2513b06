"""The 90th percentile (nearest rank) of every window request's time from
when it was due to its first token, by the engine's clock seam, in ms; a
request never served counts as a miss.  Read in the traced run, so the
profiler's cost is in it."""

from r2bench import harness


def read(records: dict):
    s = records.get("serve")
    if not s or not s.get("ttft_s"):
        return None
    return 1e3 * harness.percentile(s["ttft_s"], 90)
