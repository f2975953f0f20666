"""The benchmark's own machinery: spec, drivers, spans, trace, check."""
