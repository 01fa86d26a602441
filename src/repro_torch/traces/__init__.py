from repro_torch.traces.swf import (  # noqa: F401
    SwfReport, dump_swf, load_swf,
)
from repro_torch.traces.synthetic import (  # noqa: F401
    das2_like, sdsc_sp2_like, synthetic_trace,
)
