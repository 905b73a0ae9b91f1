"""Cross-rank reductions of the port (counterpart of ``repro/distributed``;
the JAX package's ``compat.py`` shims JAX versions and has no
counterpart here)."""
