"""The plain SSD chunk computation, re-exported for the kernels/ layout (the
reference's ``repro.kernels.ssd.ref``)."""
from repro_torch.models.ssd import ssd_chunked_ref  # noqa: F401
