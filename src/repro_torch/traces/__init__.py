from repro_torch.traces.swf import SwfReport, load_swf  # noqa: F401
from repro_torch.traces.synthetic import (  # noqa: F401
    das2_like, sdsc_sp2_like, synthetic_trace,
)
