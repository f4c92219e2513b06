"""The engine's decode by its clock seam: the window's decode time over its
decode steps, in ms."""


def read(records: dict):
    s = records.get("serve")
    if not s or not s["decode_steps"]:
        return None
    return 1e3 * s["decode_s"] / s["decode_steps"]
