"""Host utilities: metric logging, status records, resource telemetry,
atomic file publication, topology rendering and the checkpoint codec."""
