"""The port's mesh layer (counterpart of ``repro/distributed``): the
logical-axis sharding rules and ``MeshCtx`` (``sharding.py``), the
collectives (``collectives.py``) and the compressed reduction
(``compression.py``); the JAX package's ``compat.py`` shims JAX versions
and has no counterpart here."""
