"""The flash forward's share of its roofline, in %: the bound of every
prefill's launches (``formulas.flash_fwd_cost``, 3xTF32 in fp32) over their
device time in the profiler's trace."""


def read(records: dict):
    f = (records.get("serve") or {}).get("flash")
    if not f or f["device_s"] <= 0:
        return None
    return 100.0 * f["bound_s"] / f["device_s"]
