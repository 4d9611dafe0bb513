"""Placement of the port across devices: logical-axis sharding over
DTensor (:mod:`repro_torch.parallel.sharding`), the explicit collectives
over ``torch.distributed`` (:mod:`repro_torch.parallel.collectives`), and
the GPipe stage schedule on CUDA streams
(:mod:`repro_torch.parallel.pipeline_par`)."""
