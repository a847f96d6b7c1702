"""The paper's LISO / SILO serving scenarios.

A jax-free copy of the scenario presets of the reference's analytic edge
model (`repro.core.edge_model`), which the serve CLI sizes its prompts and
outputs by.  The analytic latency and energy model itself is not ported yet.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    tokens_in: int
    tokens_out: int

    @property
    def total_tokens(self) -> int:
        return self.tokens_in + self.tokens_out


LISO = Scenario("LISO", 750, 50)     # long input short output (summarize)
SILO = Scenario("SILO", 50, 750)     # short input long output (generate)
