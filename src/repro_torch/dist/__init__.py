"""Distribution layer (mirrors ``repro/dist``): int8 gradient compression.
The train step round-trips its gradients through the quantizer;
``ErrorFeedback`` carries the residual for a caller that threads it through
its state (the step does not: the biased scheme is the default, as in the
reference). The sharding rules are not ported yet (ROADMAP.md, queue 1,
item 9: sharded engine)."""

from . import compression  # noqa: F401
