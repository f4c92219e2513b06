"""Online recovery runtime: the paper's pipeline as a closed loop.

  control_plane — HEALTHY→DETECTING→DIAGNOSING→MIGRATING→REBALANCED
                  state machine over the detection / migration / balance /
                  planner models, with a per-stage latency ledger
"""
