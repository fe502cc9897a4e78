"""Source of the native ingest library and its build."""
