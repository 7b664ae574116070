"""The JAX package's ``experiments/probes/``: short training runs that
answer one question each about from-scratch P-frame training
(``probe_latent_liveness``, ``probe_dist_only``)."""
