"""Framework-free R2CCL models, copied from the JAX package.

  topology   — cluster / node / NIC (rail) model, PCIe-distance chains
  failures   — failure taxonomy (Table 2) + injection schedules
  detection  — bilateral awareness + probe triangulation (Section 4.1-4.2)
  migration  — multi-NIC registration + DMA-buffer rollback (Section 4.3)
  balance    — R2CCL-Balance NIC-level redistribution (Section 5.1)
  partition  — Appendix-A optimal split Y*, threshold ng/(3ng-2)
  reranking  — bridge-based logical re-ranking, Algorithm 1 (Section 6)
  schedule   — collective schedule IR + ring / tree builders
  allreduce  — R2CCL-AllReduce program builder (Section 5.2)
  recursive  — recursive decomposition over bandwidth spectra (Section 6)
  executor_np — numpy rank-parallel oracle executor
  planner    — alpha-beta strategy selection (Table 1)
  comm_sim   — failure-cost constants and the collective rate model
  telemetry  — metrics registry and typed trace log

and, ported to PyTorch: collectives — the schedule IR executed over
``torch.distributed`` ranks, every round merged by the chunk_combine kernel.
"""
