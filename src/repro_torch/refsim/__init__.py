"""CQsim-analogue reference simulator of the PyTorch port (pure Python,
heap-based).

Counterpart of ``repro.refsim``.  The paper validates its SST component
against CQsim; the port validates its engine against this independently
written event-driven simulator with identical pinned semantics (DESIGN.md
§8), on the host and without JAX: ``rt.run(s).matches(rt.run_ref(s))``.
"""

from repro_torch.refsim.sim import (  # noqa: F401
    ReferenceSimulator, replay_reference, simulate_reference,
)
from repro_torch.refsim.workflow import (  # noqa: F401
    simulate_workflow_reference,
)
