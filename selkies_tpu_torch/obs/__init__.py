"""Observability for the port: the health-verdict engine and flight
recorder (:mod:`.health`) and the delivered-frame meter
(:mod:`.energy`). Copies of the JAX package's stdlib-only modules."""
