"""``repro_torch.ir`` — the graph IR schema, for fingerprints and embedded
artifact graphs only.

A copy of the reference's ``repro/ir/graph_ir.py``: :class:`GraphIR` and its
canonical fingerprint, which every artifact carries and which must be
byte-equal to the reference's.  The import pipeline (``repro/ir/passes.py``)
and the tracer (``repro/ir/trace.py``) are not ported yet.
"""
from repro_torch.ir.graph_ir import IR_VERSION, GraphIR, IRError

__all__ = ["GraphIR", "IRError", "IR_VERSION"]
