"""Sources of the native Unicode decoder, built by ``utils/build.py``."""
