"""Schedule legality and semantic verification (copied from the JAX package).

  errors  — typed, provenance-carrying schedule errors
  verify  — step legality, abstract interpretation of collective semantics,
            deadlock-freedom; ``ChunkSchedule.validate`` and
            ``CollectiveProgram.validate`` call into it
  corpus  — every schedule builder over a seeded parameter sweep
"""
