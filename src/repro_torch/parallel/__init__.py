"""Placement of the port's pipeline on one device: the GPipe stage
schedule on CUDA streams (:mod:`repro_torch.parallel.pipeline_par`)."""
