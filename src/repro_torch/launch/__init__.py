"""Step builders and the serving entry point (counterpart: ``repro.launch``)."""
