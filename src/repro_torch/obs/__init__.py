"""Observability of the port: so far the measurement half of the JAX
package's ``obs/profiler.py`` (:mod:`repro_torch.obs.profiler`), which
times plans on the card. Traces, metrics, drift reports and validation
come with ROADMAP.md Queue 1 slice 7."""
