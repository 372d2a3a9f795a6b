"""The three-term roofline of the modelled TPU target (the port's copy of
``repro.roofline``)."""
from repro_torch.roofline.analysis import (HW, RooflineTerms,
                                           collective_bytes,
                                           roofline_from_artifact)

__all__ = ["HW", "RooflineTerms", "collective_bytes",
           "roofline_from_artifact"]
