"""Device time a prefill of the operations launched inside the program's
``moe.route`` and ``moe.experts`` spans (matched to the profiler's device
operations by their correlation ids), in ms: the MoE layers' router, held
experts and shared expert."""


def read(records: dict):
    s = records.get("serve")
    if not s or not s.get("moe_prefill_s") or not s.get("prefills"):
        return None
    return 1e3 * s["moe_prefill_s"] / s["prefills"]
