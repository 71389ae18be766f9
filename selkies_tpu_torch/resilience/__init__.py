"""Resilience plane of the port: the seeded fault registry
(:mod:`.faults`), a copy of the JAX package's. The supervisor and the
degradation ladder come with serving (ROADMAP A6)."""

from .faults import (FaultError, FaultRegistry, FaultSpec,  # noqa: F401
                     parse_spec)
from .faults import registry as fault_registry  # noqa: F401
