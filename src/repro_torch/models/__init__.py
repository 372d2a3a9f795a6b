"""Model path of the port (counterpart: ``repro.models``)."""
