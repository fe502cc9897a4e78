"""Source of the native ingest library, built by ``utils/build.py``."""
