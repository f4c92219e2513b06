"""Rows the held experts' products computed in the window's decode steps
over the (token, choice) slots of real rows routed to them (the driver's
``moe.expert_rows`` and ``moe.held_slots`` of decode, from the program's
route log and the graphs' rows): 1.0 would be no row computed for nothing.  Decode runs
every held expert on every row of the graph, so it reads about
``held experts x graph rows / (real rows x top_k x held share)``."""


def read(records: dict):
    m = (records.get("serve") or {}).get("moe")
    if not m or not m["decode_held_slots"]:
        return None
    return m["decode_expert_rows"] / m["decode_held_slots"]
