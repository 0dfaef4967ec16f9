"""The operator drivers of the port: each module is the counterpart of the
reference's file of the same name under ``scripts/`` and runs as
``python -m gome_tpu_torch.scripts.<name>``, on the CUDA card unless
``--device cpu`` is given.

  placement_eval    what-if placement verdict -> PLACEMENT_CUDA_r01.json
  mesh_overhead     mesh cost: part A (D=1 overhead), part B (row padding),
                    --curve (D=1/2/4/8) -> MULTICHIP_CUDA_r01.json
  fleet_drill       a 2 x 2 gateway/consumer fleet -> FLEET_CUDA_r01.json
  capacity          open-loop capacity sweep (single process, or --fleet)
                    -> CAPACITY_CUDA_r01.json
  profile_consumer  the consumer drain profile, and --gateway admit drills
                    -> HOSTPROF_CUDA_r01.json / HOSTPROF_CUDA_r02.json
  obs_snapshot      the operator bundle of every obs/ surface

``common`` holds what the drivers and ``chip_smoke.py`` share.
"""
