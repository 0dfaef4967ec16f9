"""The reference's user-facing examples (``examples/`` beside
``gome_tpu``) on the port. Each runs as ``python -m
gome_tpu_torch.examples.<name>``, on the CUDA card unless ``--device cpu``
is given, and prints what the reference's example prints:

  embed              the engine as a library: fills, cancels, depth,
                     counters and the book invariants
  migrate_from_gome  a live migration from a gome deployment's Redis
                     keyspace over a real RESP socket, and back
  sim_rollout        a market-simulator rollout and its one-line JSON
                     report (steps/s, activity, the flow's statistics)
"""
