"""The engine's prefill by its clock seam (prefill end - start), the mean
over the window's batches, in ms."""


def read(records: dict):
    s = records.get("serve")
    if not s or not s["prefill_s"]:
        return None
    return 1e3 * sum(s["prefill_s"]) / len(s["prefill_s"])
